"""Decoder LM: the port of the reference's ``models/decoder.py``, every
layer kind of the ten decoder configurations.

A model is a sequence of stages ``(kind, count)``, kind ``<mixer>[+<ffn>]``
(the reference's grammar):

  mixers: ``attn`` (full causal), ``swa`` (sliding window), ``mla``
          (DeepSeek's latent attention, ``models/mla.py``), ``mlstm`` and
          ``slstm`` (xLSTM, ``models/xlstm.py``), ``hymba`` and
          ``hymba_full`` (attention and Mamba heads side by side,
          ``models/ssm.py``; the first with a sliding window);
  ffns:   ``dense`` (SwiGLU or GELU per ``cfg.act``; an MoE config's dense
          layers take ``cfg.moe.d_ff_dense``), ``moe`` (``models/moe.py``),
          ``none``; the default is ``dense`` if ``d_ff > 0`` else ``none``.

The reference stacks each stage's layers on a leading axis and scans
them; here a stage is a list of per-layer dicts
(``params["stages"][i][j]``), and so is its cache (``cache[i][j]``: a KV
cache ``{"k", "v"}``, MLA's ``{"c_kv", "k_rope"}``, a recurrent state, or
hymba's ``{"attn": {"k", "v"}, "ssm": {"h", "conv"}}``). Every cache and
state leaf has the batch on axis 0. Three modes share one path per layer:
``train`` (causal, no cache), ``prefill`` (causal, cache out) and
``decode`` (one token against the cache). Sliding-window layers keep
rolling caches of ``window`` rows.

Training: ``lm_loss`` is the reference's (the text positions only, an
fp32 log-softmax, ``ce + aux``). Under ``model_forward(remat=True)``, the
default as in the reference, each layer of a ``train`` forward that
builds a graph runs under ``torch.utils.checkpoint`` (non-reentrant),
the counterpart of the reference's per-layer ``jax.checkpoint`` with
``nothing_saveable``: a layer keeps only its inputs and runs again in the
backward, under the plan the forward ran under; the numbers do not depend
on it. The attention saves only (q, k, v, out, lse)
(``layers/attention.py``). The embedding is cast, then gathered, as in
the reference: the gather's gradient is a scatter-add into a table in the
compute dtype, to which a tied head adds its own gradient in fp32
(ROADMAP.md speed item 13).

Every LayerNorm goes through ``ops.layer_norm``: on the card under an
``auto`` leg that is the LayerNorm kernel (K1), 2 · n_layers + 1 launches
a forward for a ``norm="layernorm"`` model (musicgen-medium), and
2 · n_layers more in a training step's recompute (its backward is plain
PyTorch, as the reference's is plain JAX). The four
non-dense families are RMSNorm models and reach no kernel: RMSNorm, the
attention, MoE, MLA, the SSM and xLSTM are plain PyTorch, as the
reference's are plain JAX.

``decode`` is functional, as the reference's is: it returns new cache
tensors and leaves the ones it was given untouched, so a caller may run
one batch under several plans and keep each plan's rows (the serving
engine does). It writes row ``lengths[b]`` of each cache with index
assignment, which raises where the reference's ``dynamic_update_slice``
would clamp an out-of-range row; the engine retires a slot before its
length reaches the cache's end.

Left out: the reference's ``_maybe_gather_kv`` (a sharding constraint
under a device mesh, the identity on one device) and its ``shard_x``
constrainer (the numbers do not depend on them; ROADMAP.md item 5g).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.exec.plan import current_plan, use_plan
from repro_torch.layers.attention import (AttnDims, _expand_kv,
                                          blockwise_attention,
                                          decode_attention, init_attention,
                                          masked_decode_softmax_av,
                                          project_qkv,
                                          sliding_window_attention)
from repro_torch.layers.attention import scatter_rows as _scatter_one
from repro_torch.layers.mlp import (gelu_mlp, init_gelu_mlp, init_swiglu,
                                    swiglu)
from repro_torch.layers.norms import (init_layer_norm, init_rms_norm,
                                      layer_norm, rms_norm)
from repro_torch.layers.params import (Params, dense, embed, init_dense,
                                       init_embedding, tree_map)
from repro_torch.layers.rotary import apply_rope
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod

def _parse_kind(kind: str, cfg: ModelConfig):
    mixer, _, ffn = kind.partition("+")
    if not ffn:
        ffn = "dense" if cfg.d_ff > 0 else "none"
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
    if mixer in ("attn", "swa"):
        p["attn"] = init_attention(
            generator, d, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    elif mixer == "mla":
        p["attn"] = mla_mod.init_mla(generator, d, cfg.n_heads, cfg.mla)
    elif mixer == "mlstm":
        p["mlstm"] = xlstm_mod.init_mlstm(generator, d, cfg.n_heads)
    elif mixer == "slstm":
        p["slstm"] = xlstm_mod.init_slstm(generator, d, cfg.n_heads)
    elif mixer in ("hymba", "hymba_full"):
        # Built without qk_norm, as in the reference.
        p["attn"] = init_attention(
            generator, d, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias)
        p["mamba"] = ssm_mod.init_mamba(generator, d, cfg.ssm)
        p["norm_attn"] = init_rms_norm(d)
        p["norm_ssm"] = init_rms_norm(d)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "dense":
        p["ln2"] = _init_norm(cfg, d)
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                else cfg.d_ff)
        if cfg.act == "swiglu":
            p["ffn"] = init_swiglu(generator, d, d_ff)
        else:
            p["ffn"] = init_gelu_mlp(generator, d, d_ff)
    elif ffn == "moe":
        p["ln2"] = _init_norm(cfg, d)
        p["moe"] = moe_mod.init_moe(generator, d, cfg.moe)
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


def _attn_prefill_cache(mixer, cfg: ModelConfig, k, v, max_cache_len):
    if mixer == "swa":
        kc, vc = _swa_cache_from_prefill(k, v, cfg.sliding_window)
        return {"k": kc, "v": vc}
    if cfg.kv_cache_int8:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return _pad_cache_seq({"k": kq, "k_s": ks, "v": vq, "v_s": vs},
                              max_cache_len)
    return _pad_cache_seq({"k": k, "v": v}, max_cache_len)


def _attn_decode(mixer, p, x_n, cfg: ModelConfig, cache, lengths,
                 positions):
    """(context, new cache) of one decode step of an ``attn`` or ``swa``
    layer."""
    q, k, v = _qkv_roped(p, x_n, cfg, positions)
    if mixer == "swa":
        rows = lengths % cache["k"].shape[1]
        ck, cv = _scatter_kv(cache["k"], cache["v"], k, v, rows)
        return (_swa_decode_attn(q, ck, cv, lengths, cfg.sliding_window),
                {"k": ck, "v": cv})
    if cfg.kv_cache_int8:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        ck = _scatter_one(cache["k"], kq, lengths)
        cks = _scatter_one(cache["k_s"], ks, lengths)
        cv = _scatter_one(cache["v"], vq, lengths)
        cvs = _scatter_one(cache["v_s"], vs, lengths)
        ctx = decode_attention(q, _dequantize_kv(ck, cks),
                               _dequantize_kv(cv, cvs), lengths + 1)
        return ctx, {"k": ck, "k_s": cks, "v": cv, "v_s": cvs}
    ck, cv = _scatter_kv(cache["k"], cache["v"], k, v, lengths)
    return decode_attention(q, ck, cv, lengths + 1), {"k": ck, "v": cv}


def _hymba(p, x_n, cfg: ModelConfig, window: int, *, mode, cache, lengths,
           positions, max_cache_len):
    """Hymba's layer: the attention heads (a sliding window of ``window``
    tokens, or full causal where it is 0) beside the Mamba heads, fused as
    the mean of the two branches, each RMS-normed. Returns (y, cache)."""
    s = x_n.shape[1]
    q, k, v = _qkv_roped(p["attn"], x_n, cfg, positions)
    new_cache = cache
    if mode != "decode":
        if window:
            ctx = sliding_window_attention(
                q, k, v, window=window,
                q_block=min(cfg.attn_q_block or 512, s))
        else:
            ctx = blockwise_attention(q, k, v, causal=True,
                                      q_block=cfg.attn_q_block or s,
                                      kv_block=cfg.attn_kv_block)
        ssm_y, ssm_st = ssm_mod.mamba_forward(p["mamba"], x_n, cfg.ssm)
        if mode == "prefill":
            if window:
                kc, vc = _swa_cache_from_prefill(k, v, window)
            else:
                padded = _pad_cache_seq({"k": k, "v": v}, max_cache_len)
                kc, vc = padded["k"], padded["v"]
            new_cache = {"attn": {"k": kc, "v": vc}, "ssm": ssm_st}
    else:
        ca = cache["attn"]
        if window:
            rows = lengths % ca["k"].shape[1]
            ck, cv = _scatter_kv(ca["k"], ca["v"], k, v, rows)
            ctx = _swa_decode_attn(q, ck, cv, lengths, window)
        else:
            ck, cv = _scatter_kv(ca["k"], ca["v"], k, v, lengths)
            ctx = decode_attention(q, ck, cv, lengths + 1)
        ssm_y, ssm_st = ssm_mod.mamba_decode(p["mamba"], x_n, cache["ssm"],
                                             cfg.ssm)
        new_cache = {"attn": {"k": ck, "v": cv}, "ssm": ssm_st}
    attn_y = _out_proj(p["attn"], ctx)
    y = 0.5 * (rms_norm(p["norm_attn"], attn_y)
               + rms_norm(p["norm_ssm"], ssm_y))
    return y, new_cache


def apply_layer(p: Params, x, cfg: ModelConfig, kind: str, *, mode: str,
                cache=None, lengths=None, max_cache_len: int | None = None):
    """Returns (x_out, new_cache, aux): x (B, S, d), (B, 1, d) in decode;
    aux the layer's MoE loss (an fp32 zero for the other kinds)."""
    mixer, ffn = _parse_kind(kind, cfg)
    s = x.shape[1]
    x_n = _norm(cfg, p["ln1"], x)
    if mode == "decode":
        positions = lengths[:, None]
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    new_cache = cache
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seq = mode in ("train", "prefill")

    if mixer in ("attn", "swa"):
        if seq:
            fn = _attn_full if mixer == "attn" else _attn_swa
            ctx, (k, v) = fn(p["attn"], x_n, cfg, positions)
            if mode == "prefill":
                new_cache = _attn_prefill_cache(mixer, cfg, k, v,
                                                max_cache_len)
        else:
            ctx, new_cache = _attn_decode(mixer, p["attn"], x_n, cfg, cache,
                                          lengths, positions)
        y = _out_proj(p["attn"], ctx)
    elif mixer == "mla":
        if seq:
            y, kv = mla_mod.mla_attention_train(
                p["attn"], x_n, cfg.n_heads, cfg.mla, positions=positions,
                theta=cfg.rope_theta, q_block=cfg.attn_q_block,
                kv_block=cfg.attn_kv_block)
            if mode == "prefill":
                new_cache = _pad_cache_seq(kv, max_cache_len)
        else:
            y, new_cache = mla_mod.mla_attention_decode(
                p["attn"], x_n, cache, lengths, cfg.n_heads, cfg.mla,
                theta=cfg.rope_theta)
    elif mixer in ("mlstm", "slstm"):
        block = p[mixer]
        if mixer == "mlstm":
            y, st = (xlstm_mod.mlstm_forward(block, x_n, cfg.n_heads) if seq
                     else xlstm_mod.mlstm_decode(block, x_n, cache,
                                                 cfg.n_heads))
        else:
            y, st = (xlstm_mod.slstm_forward(block, x_n) if seq
                     else xlstm_mod.slstm_decode(block, x_n, cache))
        new_cache = None if mode == "train" else st
    elif mixer in ("hymba", "hymba_full"):
        window = cfg.sliding_window if mixer == "hymba" else 0
        y, new_cache = _hymba(p, x_n, cfg, window, mode=mode, cache=cache,
                              lengths=lengths, positions=positions,
                              max_cache_len=max_cache_len)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    x = x + y

    if ffn == "dense":
        h = _norm(cfg, p["ln2"], x)
        h = swiglu(p["ffn"], h) if cfg.act == "swiglu" else gelu_mlp(p["ffn"],
                                                                     h)
        x = x + h
    elif ffn == "moe":
        h, aux = moe_mod.moe_ffn(p["moe"], _norm(cfg, p["ln2"], x), cfg.moe)
        x = x + h
    return x, new_cache, aux


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

    def kv_cache(seq):
        return {n: torch.zeros((batch, seq, kv, hd), dtype=dtype,
                               device=device) for n in ("k", "v")}

    def mamba_state():
        return ssm_mod.init_mamba_state(batch, cfg.ssm.expand * cfg.d_model,
                                        cfg.ssm, device=device)

    if mixer == "attn":
        if not cfg.kv_cache_int8:
            return kv_cache(max_seq)
        vals = {n: torch.zeros((batch, max_seq, kv, hd), dtype=torch.int8,
                               device=device) for n in ("k", "v")}
        scales = {n: torch.zeros((batch, max_seq, kv, 1),
                                 dtype=torch.bfloat16, device=device)
                  for n in ("k_s", "v_s")}
        return {"k": vals["k"], "k_s": scales["k_s"], "v": vals["v"],
                "v_s": scales["v_s"]}
    if mixer == "swa":
        return kv_cache(min(cfg.sliding_window, max_seq))
    if mixer == "mla":
        return mla_mod.init_mla_cache(batch, max_seq, cfg.mla, dtype,
                                      device=device)
    if mixer == "mlstm":
        return xlstm_mod.init_mlstm_state(batch, 2 * cfg.d_model,
                                          cfg.n_heads, device=device)
    if mixer == "slstm":
        return xlstm_mod.init_slstm_state(batch, cfg.d_model, device=device)
    if mixer == "hymba":
        return {"attn": kv_cache(min(cfg.sliding_window, max_seq)),
                "ssm": mamba_state()}
    if mixer == "hymba_full":
        return {"attn": kv_cache(max_seq), "ssm": mamba_state()}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches and states, ``cache[stage][layer]`` the reference's
    per-layer tree: (batch, rows, KV, hd) K/V (rows ``max_seq``, or
    ``min(window, max_seq)`` for a sliding-window layer), MLA's latent
    rows, or a recurrent state (fp32; the stabilisers at -1e30)."""
    return [[_layer_cache(cfg, kind, batch, max_seq, dtype, device)
             for _ in range(count)] for kind, count in cfg.resolved_stages]


def _train_layer(p, x, cfg: ModelConfig, kind: str, plan):
    """One layer of a ``train`` forward under ``plan``: (x, aux). The
    checkpointed layer's recompute runs on the backward's thread, which
    does not see the forward's plan unless the layer re-enters it."""
    with use_plan(plan):
        x, _, aux = apply_layer(p, x, cfg, kind, mode="train")
    return x, aux


def model_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  mode: str = "train", cache=None, lengths=None,
                  prefix_embeds=None, remat: bool = True,
                  max_cache_len: int | None = None,
                  compute_dtype=torch.bfloat16):
    """tokens: (B, S_text) int64 or int32 (S_text = 1 in decode) on the
    parameters' device; ``prefix_embeds`` (B, P, d) for the VLM and audio
    stubs (train and prefill). Returns {"logits", "cache", "aux"}: the
    cache None in train mode; ``aux`` the MoE loss summed over the layers
    in train and prefill, an fp32 zero in decode, as in the reference.
    ``remat``: in train mode, when a graph is being built, each layer is
    checkpointed (recomputed in the backward)."""
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

    remat = remat and mode == "train" and torch.is_grad_enabled()
    plan = current_plan()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for si, (kind, _) in enumerate(cfg.resolved_stages):
        stage_cache, stage_aux = [], []
        for li, p in enumerate(params["stages"][si]):
            if mode == "decode":
                x, c, _ = apply_layer(p, x, cfg, kind, mode="decode",
                                      cache=cache[si][li], lengths=lengths)
            elif remat:
                x, aux = checkpoint(_train_layer, p, x, cfg, kind, plan,
                                    use_reentrant=False)
                c = None
                stage_aux.append(aux)
            else:
                x, c, aux = apply_layer(p, x, cfg, kind, mode=mode,
                                        max_cache_len=max_cache_len)
                stage_aux.append(aux)
            stage_cache.append(c)
        new_caches.append(stage_cache)
        if stage_aux:
            # The reference sums a stage's losses, then adds the stage's.
            aux_total = aux_total + torch.stack(stage_aux).sum()

    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = dense(params["head"], x)
    return {"logits": logits,
            "cache": new_caches if mode != "train" else None,
            "aux": aux_total}


def lm_loss(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True, compute_dtype=torch.bfloat16):
    """The reference's ``lm_loss``. batch: ``tokens``, ``targets`` (B, S)
    integers, ``mask`` (B, S) float, optional ``prefix_embeds``. The loss
    is taken on the text positions only (the prefix's are dropped): the
    targets' fp32 log-probabilities, ``ce = −Σ ll·mask / (Σ mask + 1e-6)``
    and ``loss = ce + aux``. Returns (loss, {"loss", "ce", "aux", "ppl"}),
    ``ppl = exp(min(ce, 20))``."""
    out = model_forward(params, batch["tokens"], cfg, mode="train",
                        prefix_embeds=batch.get("prefix_embeds"), remat=remat,
                        compute_dtype=compute_dtype)
    n_text = batch["tokens"].shape[1]
    logits = out["logits"][:, -n_text:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, batch["targets"].long()[..., None])[..., 0]
    mask = batch["mask"]
    ce = -(ll * mask).sum() / (mask.sum() + 1e-6)
    loss = ce + out["aux"]
    return loss, {"loss": loss, "ce": ce, "aux": out["aux"],
                  "ppl": torch.exp(torch.clamp(ce, max=20.0))}
