"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the port of
the reference's ``models/mla.py``, plain PyTorch as the reference's is
plain JAX.

Keys and values are compressed into a latent ``c_kv`` (``kv_lora`` wide)
plus one shared rotary key (``rope_dim``). Prefill materialises per-head
K/V from the latent and runs ``blockwise_attention`` (q/k heads
``nope + rope`` wide, v heads ``v_dim``: its accumulator is sized by v).
Decode uses the absorbed form: W_uk folded into the query, W_uv applied
after attention, so the cache is ``(c_kv, k_rope)`` per token. The two
logit terms are summed in the compute dtype before the fp32 cast, as in
the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.layers.attention import (NEG_INF, blockwise_attention,
                                          scatter_rows)
from repro_torch.layers.norms import init_rms_norm, rms_norm
from repro_torch.layers.params import Params, dense, init_dense
from repro_torch.layers.rotary import apply_rope


def init_mla(generator: torch.Generator, d_model: int, n_heads: int,
             mla: MLAConfig, dtype=torch.float32) -> Params:
    qd = mla.nope_dim + mla.rope_dim
    return {
        "q_down": init_dense(generator, d_model, mla.q_lora, bias=False,
                             dtype=dtype),
        "q_norm": init_rms_norm(mla.q_lora, dtype),
        "q_up": init_dense(generator, mla.q_lora, n_heads * qd, bias=False,
                           dtype=dtype),
        "kv_down": init_dense(generator, d_model, mla.kv_lora + mla.rope_dim,
                              bias=False, dtype=dtype),
        "kv_norm": init_rms_norm(mla.kv_lora, dtype),
        "kv_up": init_dense(generator, mla.kv_lora,
                            n_heads * (mla.nope_dim + mla.v_dim), bias=False,
                            dtype=dtype),
        "out": init_dense(generator, n_heads * mla.v_dim, d_model, bias=False,
                          zero_init=True, dtype=dtype),
    }


def _project_q(p, x, n_heads, mla: MLAConfig, positions, theta):
    b, s, _ = x.shape
    q = dense(p["q_up"], rms_norm(p["q_norm"], dense(p["q_down"], x)))
    q = q.reshape(b, s, n_heads, mla.nope_dim + mla.rope_dim)
    q_nope, q_rope = q.split([mla.nope_dim, mla.rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, theta)


def _compress_kv(p, x, mla: MLAConfig, positions, theta):
    ckv = dense(p["kv_down"], x)
    c_kv, k_rope = ckv.split([mla.kv_lora, mla.rope_dim], dim=-1)
    c_kv = rms_norm(p["kv_norm"], c_kv)                     # (B, S, kv_lora)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0]
    return c_kv, k_rope                                      # (B, S, rope)


def mla_attention_train(p, x, n_heads, mla: MLAConfig, *, positions,
                        theta: float = 10000.0, q_block: int = 512,
                        kv_block: int = 1024):
    """The materialised form (train and prefill), causal; returns (out,
    cache {"c_kv", "k_rope"})."""
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(p, x, n_heads, mla, positions, theta)
    c_kv, k_rope = _compress_kv(p, x, mla, positions, theta)
    kv = dense(p["kv_up"], c_kv).reshape(b, s, n_heads,
                                         mla.nope_dim + mla.v_dim)
    k_nope, v = kv.split([mla.nope_dim, mla.v_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, n_heads, mla.rope_dim)], dim=-1)
    ctx = blockwise_attention(q, k, v, causal=True, q_block=q_block or s,
                              kv_block=kv_block)
    out = dense(p["out"], ctx.reshape(b, s, -1))
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_attention_decode(p, x, cache, cache_len, n_heads, mla: MLAConfig, *,
                         theta: float = 10000.0):
    """The absorbed form: attention in latent space against the cache
    (c_kv (B, S, kv_lora), k_rope (B, S, rope)); x (B, 1, d)."""
    b = x.shape[0]
    pos = cache_len[:, None]
    q_nope, q_rope = _project_q(p, x, n_heads, mla, pos, theta)
    c_new, kr_new = _compress_kv(p, x, mla, pos, theta)
    c_kv = scatter_rows(cache["c_kv"], c_new, cache_len)
    k_rope = scatter_rows(cache["k_rope"], kr_new, cache_len)

    w_uk = p["kv_up"]["w"].reshape(mla.kv_lora, n_heads,
                                   mla.nope_dim + mla.v_dim)
    w_k = w_uk[:, :, :mla.nope_dim]                # (kv_lora, H, nope)
    w_v = w_uk[:, :, mla.nope_dim:]                # (kv_lora, H, v)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, w_k.to(q_nope.dtype))
    scale = 1.0 / math.sqrt(float(mla.nope_dim + mla.rope_dim))
    logits = (torch.einsum("bqhl,bsl->bhqs", q_lat, c_kv.to(q_lat.dtype))
              + torch.einsum("bqhr,bsr->bhqs", q_rope,
                             k_rope.to(q_rope.dtype))).float() * scale
    valid = (torch.arange(c_kv.shape[1], device=x.device)[None, :]
             <= cache_len[:, None])
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx_lat = torch.einsum("bhqs,bsl->bqhl", probs.to(c_kv.dtype), c_kv)
    ctx = torch.einsum("bqhl,lhv->bqhv", ctx_lat, w_v.to(ctx_lat.dtype))
    out = dense(p["out"], ctx.reshape(b, 1, -1))
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def init_mla_cache(batch: int, seq: int, mla: MLAConfig,
                   dtype=torch.bfloat16, device=None):
    return {
        "c_kv": torch.zeros((batch, seq, mla.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, seq, mla.rope_dim), dtype=dtype,
                              device=device),
    }
