"""Decoder LM: the port of the reference's ``models/decoder.py`` for the
dense family (mixers ``attn`` and ``swa``, dense FFN).

A model is a sequence of stages ``(kind, count)``, kind ``<mixer>[+<ffn>]``
(the reference's grammar). The reference stacks each stage's layers on a
leading axis and scans them; here a stage is a list of per-layer dicts
(``params["stages"][i][j]``), and so is its cache
(``cache[i][j] = {"k": ..., "v": ...}``). Three modes share one path per
layer: ``train`` (causal, no cache; forward only here), ``prefill`` (causal,
cache out) and ``decode`` (one token against the cache). Sliding-window
layers keep rolling caches of ``window`` rows.

Every LayerNorm goes through ``ops.layer_norm``: on the card under an
``auto`` leg that is the LayerNorm kernel (K1), 2 · n_layers + 1 launches
a forward for a ``norm="layernorm"`` model (musicgen-medium). RMSNorm and
the attention are plain PyTorch, as the reference's are plain JAX.

``decode`` is functional, as the reference's is: it returns new cache
tensors and leaves the ones it was given untouched, so a caller may run
one batch under several plans and keep each plan's rows (the serving
engine does). It writes row ``lengths[b]`` of each cache with index
assignment, which raises where the reference's ``dynamic_update_slice``
would clamp an out-of-range row; the engine retires a slot before its
length reaches the cache's end.

Left out: the ``mla``, ``mlstm``, ``slstm``, ``hymba`` and ``hymba_full``
mixers and the ``moe`` FFN (they raise ``NotImplementedError``), the
reference's ``_maybe_gather_kv`` (a sharding constraint under a device
mesh, the identity on one device), its ``shard_x`` constrainer and
``remat`` (the forward's numbers do not depend on them), and ``lm_loss``
(decoder training).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (AttnDims, _expand_kv,
                                          blockwise_attention,
                                          decode_attention, init_attention,
                                          masked_decode_softmax_av,
                                          project_qkv,
                                          sliding_window_attention)
from repro_torch.layers.mlp import (gelu_mlp, init_gelu_mlp, init_swiglu,
                                    swiglu)
from repro_torch.layers.norms import (init_layer_norm, init_rms_norm,
                                      layer_norm, rms_norm)
from repro_torch.layers.params import (Params, dense, embed, init_dense,
                                       init_embedding, tree_map)
from repro_torch.layers.rotary import apply_rope

PORTED_MIXERS = ("attn", "swa")
PORTED_FFNS = ("dense", "none")
# Where the kinds this slice leaves out will come from.
LATER_SLICE = ("ROADMAP.md Queue 1 item 5b (models/moe.py, mla.py, ssm.py, "
               "xlstm.py and the hymba, MoE and MLA kinds)")


def _parse_kind(kind: str, cfg: ModelConfig):
    """(mixer, ffn) of a layer kind; raises ``NotImplementedError`` for a
    kind this slice of the port does not run."""
    mixer, _, ffn = kind.partition("+")
    if not ffn:
        ffn = "dense" if cfg.d_ff > 0 else "none"
    if mixer not in PORTED_MIXERS or ffn not in PORTED_FFNS:
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r} (mixer {mixer!r}, ffn "
            f"{ffn!r}) is not ported yet; it comes with {LATER_SLICE}")
    return mixer, ffn


def _init_norm(cfg: ModelConfig, d: int):
    return init_rms_norm(d) if cfg.norm == "rmsnorm" else init_layer_norm(d)


def _norm(cfg: ModelConfig, p, x):
    return rms_norm(p, x) if cfg.norm == "rmsnorm" else layer_norm(p, x)


# ---------------------------------------------------------------------------
# layer init and apply
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ModelConfig,
               kind: str) -> Params:
    mixer, ffn = _parse_kind(kind, cfg)
    d = cfg.d_model
    p: Params = {"ln1": _init_norm(cfg, d)}
    p["attn"] = init_attention(
        generator, d, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    if ffn == "dense":
        p["ln2"] = _init_norm(cfg, d)
        if cfg.act == "swiglu":
            p["ffn"] = init_swiglu(generator, d, cfg.d_ff)
        else:
            p["ffn"] = init_gelu_mlp(generator, d, cfg.d_ff)
    return p


def _qkv_roped(p, x_n, cfg: ModelConfig, positions):
    dims = AttnDims(cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim)
    q, k, v = project_qkv(p, x_n, dims, compute_dtype=x_n.dtype)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _attn_full(p, x_n, cfg: ModelConfig, positions):
    q, k, v = _qkv_roped(p, x_n, cfg, positions)
    qb = cfg.attn_q_block or q.shape[1]
    ctx = blockwise_attention(q, k, v, causal=True, q_block=qb,
                              kv_block=cfg.attn_kv_block)
    return ctx, (k, v)


def _attn_swa(p, x_n, cfg: ModelConfig, positions):
    q, k, v = _qkv_roped(p, x_n, cfg, positions)
    # SWA keeps small q blocks (its windowed slicing needs them); 0 keeps
    # the default rather than the full length.
    qb = cfg.attn_q_block or 512
    ctx = sliding_window_attention(q, k, v, window=cfg.sliding_window,
                                   q_block=min(qb, q.shape[1]))
    return ctx, (k, v)


def _out_proj(p, ctx):
    flat = ctx.flatten(-2)
    return flat @ p["wo"]["w"].to(flat.dtype)


def _swa_cache_from_prefill(k, v, window: int):
    """The last ``window`` KV rows at their rolling slots: slot j holds the
    last position p < S with p % window == j (zeros where there is none)."""
    s = k.shape[1]
    j = torch.arange(window, device=k.device)
    p_j = s - 1 - ((s - 1 - j) % window)
    valid = (p_j >= 0)[None, :, None, None]
    p_j = p_j.clamp(0, s - 1)
    return (k[:, p_j] * valid.to(k.dtype), v[:, p_j] * valid.to(v.dtype))


def _swa_decode_attn(q, k_cache, v_cache, lengths, window: int):
    """Rolling-cache decode attention: slot j holds position
    L - ((L - j) mod W), L the current position. The validity mask is the
    reference's expression as Python reads it (``&`` before ``|``): the
    slot being written, or a filled slot among the last ``window - 1``
    positions."""
    w = k_cache.shape[1]
    j = torch.arange(w, device=q.device)[None, :]
    big_l = lengths[:, None]
    p_j = big_l - ((big_l - j) % w)
    valid = (p_j >= 0) & (p_j >= big_l - window + 1) | (j == (big_l % w))
    h = q.shape[2]
    return masked_decode_softmax_av(q, _expand_kv(k_cache, h),
                                    _expand_kv(v_cache, h), valid)


def _quantize_kv(x):
    """Per-(token, kv-head) symmetric int8: x (B, S, KV, hd) -> (int8
    values, bf16 scales (B, S, KV, 1)); rounds half to even."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale.float()).to(dtype)


def _scatter_one(cache, new, rows):
    """A copy of ``cache`` (B, S, ...) with row ``rows[b]`` of batch b set
    to ``new[b, 0]``."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), rows] = \
        new[:, 0].to(cache.dtype)
    return out


def _scatter_kv(cache_k, cache_v, k_new, v_new, rows):
    return _scatter_one(cache_k, k_new, rows), _scatter_one(cache_v, v_new,
                                                            rows)


def _pad_cache_seq(tree, max_len: int | None):
    """Pad prefill caches (axis 1 = sequence) with zeros out to the decode
    horizon."""
    if max_len is None:
        return tree

    def pad(x):
        if x.ndim >= 2 and x.shape[1] < max_len:
            widths = [0, 0] * (x.ndim - 2) + [0, max_len - x.shape[1]]
            return F.pad(x, widths)
        return x

    return tree_map(pad, tree)


def apply_layer(p: Params, x, cfg: ModelConfig, kind: str, *, mode: str,
                cache=None, lengths=None, max_cache_len: int | None = None):
    """Returns (x_out, new_cache). x: (B, S, d), (B, 1, d) in decode."""
    mixer, ffn = _parse_kind(kind, cfg)
    s = x.shape[1]
    x_n = _norm(cfg, p["ln1"], x)
    if mode == "decode":
        positions = lengths[:, None]
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    new_cache = cache

    if mode in ("train", "prefill"):
        fn = _attn_full if mixer == "attn" else _attn_swa
        ctx, (k, v) = fn(p["attn"], x_n, cfg, positions)
        if mode == "prefill":
            if mixer == "swa":
                kc, vc = _swa_cache_from_prefill(k, v, cfg.sliding_window)
                new_cache = {"k": kc, "v": vc}
            elif cfg.kv_cache_int8:
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                new_cache = _pad_cache_seq(
                    {"k": kq, "k_s": ks, "v": vq, "v_s": vs}, max_cache_len)
            else:
                new_cache = _pad_cache_seq({"k": k, "v": v}, max_cache_len)
    else:
        q, k, v = _qkv_roped(p["attn"], x_n, cfg, positions)
        if mixer == "swa":
            rows = lengths % cache["k"].shape[1]
            ck, cv = _scatter_kv(cache["k"], cache["v"], k, v, rows)
            ctx = _swa_decode_attn(q, ck, cv, lengths, cfg.sliding_window)
            new_cache = {"k": ck, "v": cv}
        elif cfg.kv_cache_int8:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            ck = _scatter_one(cache["k"], kq, lengths)
            cks = _scatter_one(cache["k_s"], ks, lengths)
            cv = _scatter_one(cache["v"], vq, lengths)
            cvs = _scatter_one(cache["v_s"], vs, lengths)
            ctx = decode_attention(q, _dequantize_kv(ck, cks),
                                   _dequantize_kv(cv, cvs), lengths + 1)
            new_cache = {"k": ck, "k_s": cks, "v": cv, "v_s": cvs}
        else:
            ck, cv = _scatter_kv(cache["k"], cache["v"], k, v, lengths)
            ctx = decode_attention(q, ck, cv, lengths + 1)
            new_cache = {"k": ck, "v": cv}
    x = x + _out_proj(p["attn"], ctx)

    if ffn == "dense":
        h = _norm(cfg, p["ln2"], x)
        h = swiglu(p["ffn"], h) if cfg.act == "swiglu" else gelu_mlp(p["ffn"],
                                                                     h)
        x = x + h
    return x, new_cache


# ---------------------------------------------------------------------------
# model: init, cache, forward
# ---------------------------------------------------------------------------

def init_model(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The port's own init: the reference's tree with each stage a list of
    per-layer dicts, made on the default device (a ``torch.device``
    context) from a ``generator`` of that device."""
    params: Params = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model),
        "final_norm": _init_norm(cfg, cfg.d_model),
        "stages": [[init_layer(generator, cfg, kind) for _ in range(count)]
                   for kind, count in cfg.resolved_stages],
    }
    if not cfg.tie_embeddings:
        params["head"] = init_dense(generator, cfg.d_model, cfg.vocab,
                                    bias=False)
    return params


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                 dtype, device):
    mixer, _ = _parse_kind(kind, cfg)
    kv, hd = cfg.n_kv, cfg.resolved_head_dim
    if mixer == "swa":
        seq = min(cfg.sliding_window, max_seq)
        return {n: torch.zeros((batch, seq, kv, hd), dtype=dtype,
                               device=device) for n in ("k", "v")}
    if cfg.kv_cache_int8:
        vals = {n: torch.zeros((batch, max_seq, kv, hd), dtype=torch.int8,
                               device=device) for n in ("k", "v")}
        scales = {n: torch.zeros((batch, max_seq, kv, 1),
                                 dtype=torch.bfloat16, device=device)
                  for n in ("k_s", "v_s")}
        return {"k": vals["k"], "k_s": scales["k_s"], "v": vals["v"],
                "v_s": scales["v_s"]}
    return {n: torch.zeros((batch, max_seq, kv, hd), dtype=dtype,
                           device=device) for n in ("k", "v")}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches, ``cache[stage][layer]`` a dict of (batch, rows, KV, hd)
    tensors (rows: ``max_seq``, or ``min(window, max_seq)`` for a
    sliding-window layer)."""
    return [[_layer_cache(cfg, kind, batch, max_seq, dtype, device)
             for _ in range(count)] for kind, count in cfg.resolved_stages]


def model_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  mode: str = "train", cache=None, lengths=None,
                  prefix_embeds=None, max_cache_len: int | None = None,
                  compute_dtype=torch.bfloat16):
    """tokens: (B, S_text) int64 or int32 (S_text = 1 in decode) on the
    parameters' device; ``prefix_embeds`` (B, P, d) for the VLM and audio
    stubs (train and prefill). Returns {"logits", "cache"}, the cache None
    in train mode (the reference's ``aux``, the MoE loss, comes with the
    MoE kinds)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"model_forward: unknown mode {mode!r}")
    x = embed(params["embed"], tokens, compute_dtype)
    if cfg.modality and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(compute_dtype), x], dim=1)
    if cfg.family == "dense" and cfg.norm == "rmsnorm" and cfg.qk_norm:
        # Gemma's convention: embeddings scaled by sqrt(d_model), the
        # factor rounded to fp32 and then to the compute dtype.
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)

    new_caches = []
    for si, (kind, _) in enumerate(cfg.resolved_stages):
        stage_cache = []
        for li, p in enumerate(params["stages"][si]):
            if mode == "decode":
                x, c = apply_layer(p, x, cfg, kind, mode="decode",
                                   cache=cache[si][li], lengths=lengths)
            else:
                x, c = apply_layer(p, x, cfg, kind, mode=mode,
                                   max_cache_len=max_cache_len)
            stage_cache.append(c)
        new_caches.append(stage_cache)

    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = dense(params["head"], x)
    return {"logits": logits,
            "cache": new_caches if mode != "train" else None}
