"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM (matrix memory) and
sLSTM (scalar memory, recurrent): the port of the reference's
``models/xlstm.py``, plain PyTorch as the reference's is plain JAX.

mLSTM runs chunkwise-parallel for train and prefill (quadratic inside a
chunk of up to 256 tokens, the (C, n, m) state carried across chunks) and
as an O(1)-state recurrence for decode. The sequence length must be a
multiple of ``min(chunk, S)``: the reference asserts it, the port raises
``ValueError`` there (ROADMAP.md R8). sLSTM scans over time in both modes;
its recurrent product ``dense(r, h)`` runs in fp32 even under bf16,
because ``dense`` casts the weight to the fp32 state's dtype. Both use
exponential gating with the max-state stabiliser m, which starts at
-1e30; ``log_d`` holds -inf off the causal triangle.

``init_mlstm`` keeps the reference's zero-size leaf ``"_di"`` (0, di),
which records d_inner for shape inference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.norms import init_rms_norm, rms_norm
from repro_torch.layers.params import Params, dense, init_dense

M_INIT = -1e30


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), the reference's log sigmoid."""
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, d_model: int, n_heads: int,
               expand: int = 2, dtype=torch.float32) -> Params:
    di = expand * d_model
    return {
        "up": init_dense(generator, d_model, 2 * di, bias=False, dtype=dtype),
        "qkv": init_dense(generator, di, 3 * di, bias=False, dtype=dtype),
        "gates": init_dense(generator, di, 2 * n_heads, bias=True,
                            dtype=dtype),
        "norm": init_rms_norm(di, dtype),
        "down": init_dense(generator, di, d_model, bias=False, zero_init=True,
                           dtype=dtype),
        "_di": torch.zeros((0, di), dtype=dtype),
    }


def _mlstm_in(p, x, n_heads):
    """q, k (scaled by 1/sqrt(hd)), v as fp32 (B, S, H, hd), the fp32
    log input and forget gates (B, S, H), and the output gate z."""
    b, s, _ = x.shape
    x_in, z = dense(p["up"], x).chunk(2, dim=-1)
    hd = x_in.shape[-1] // n_heads
    q, k, v = dense(p["qkv"], x_in).chunk(3, dim=-1)
    q = q.reshape(b, s, n_heads, hd).float()
    k = k.reshape(b, s, n_heads, hd).float() / math.sqrt(float(hd))
    v = v.reshape(b, s, n_heads, hd).float()
    log_i, log_f = dense(p["gates"], x_in).float().chunk(2, dim=-1)
    return q, k, v, log_i, _log_sigmoid(log_f), z


def _mlstm_out(p, h, z, dtype):
    out = rms_norm(p["norm"], h.to(dtype))
    out = out * F.silu(z.float()).to(dtype)
    return dense(p["down"], out)


def _mlstm_chunk(carry, q_i, k_i, v_i, li, lf):
    """One chunk of L tokens against the carried state: (new state, h
    (B, L, H, hd))."""
    c_p, n_p, m_p = carry["C"], carry["n"], carry["m"]
    length = q_i.shape[1]
    bcf = torch.cumsum(lf, dim=1)                   # inclusive (B, L, H)
    # Intra-chunk decay: for t >= j, b_t - b_j + i_j.
    log_d = bcf[:, :, None] - bcf[:, None, :] + li[:, None, :, :]
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=q_i.device).tril()
    log_d = log_d.masked_fill(~causal[None, :, :, None], float("-inf"))
    intra_max = log_d.amax(dim=2)                   # (B, L, H)
    inter = bcf + m_p[:, None, :]                   # b_t + m_prev
    m_t = torch.maximum(intra_max, inter)
    d_mat = torch.exp(log_d - m_t[:, :, None])
    scores = torch.einsum("bihd,bjhd->bijh", q_i, k_i)
    w = scores * d_mat
    inter_w = torch.exp(inter - m_t)                # (B, L, H)
    h_intra = torch.einsum("bijh,bjhd->bihd", w, v_i)
    h_inter = torch.einsum("bihd,bhde->bihe", q_i, c_p) * inter_w[..., None]
    n_vec = torch.einsum("bijh,bjhd->bihd", d_mat, k_i)
    n_vec = n_vec + inter_w[..., None] * n_p[:, None, :, :]
    den = torch.einsum("bihd,bihd->bih", n_vec, q_i).abs()
    den = torch.maximum(den, torch.exp(-m_t)) + 1e-6
    h = (h_intra + h_inter) / den[..., None]

    b_last = bcf[:, -1:, :]                         # (B, 1, H)
    m_new = torch.maximum(b_last[:, 0] + m_p,
                          (b_last - bcf + li).amax(dim=1))
    w_end = torch.exp(b_last - bcf + li - m_new[:, None, :])
    decay = torch.exp(b_last[:, 0] + m_p - m_new)
    c_new = (decay[..., None, None] * c_p
             + torch.einsum("bjh,bjhd,bjhe->bhde", w_end, k_i, v_i))
    n_new = decay[..., None] * n_p + torch.einsum("bjh,bjhd->bhd", w_end, k_i)
    return {"C": c_new, "n": n_new, "m": m_new}, h


def mlstm_forward(p: Params, x: torch.Tensor, n_heads: int, *,
                  chunk: int = 256, state=None):
    """Chunkwise-parallel mLSTM (train and prefill). x: (B, S, d). Returns
    (out (B, S, d), state {"C", "n", "m"}). Raises ``ValueError`` when S
    is not a multiple of ``min(chunk, S)`` (ROADMAP.md R8)."""
    b, s, _ = x.shape
    q, k, v, log_i, log_f, z = _mlstm_in(p, x, n_heads)
    di = z.shape[-1]
    length = min(chunk, s)
    if s % length:
        raise ValueError(f"mlstm_forward: sequence length {s} is not a "
                         f"multiple of the chunk size {length}")
    if state is None:
        state = init_mlstm_state(b, di, n_heads, device=x.device)
    hs = []
    for c in range(s // length):
        sl = slice(c * length, (c + 1) * length)
        state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                log_i[:, sl], log_f[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, s, di)
    return _mlstm_out(p, h, z, x.dtype), state


def mlstm_decode(p: Params, x: torch.Tensor, state, n_heads: int):
    """The O(1) recurrent step. x: (B, 1, d)."""
    b = x.shape[0]
    q, k, v, log_i, log_f, z = _mlstm_in(p, x, n_heads)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]             # (B, H, hd)
    log_i, log_f = log_i[:, 0], log_f[:, 0]         # (B, H)
    m_new = torch.maximum(log_f + state["m"], log_i)
    f_s = torch.exp(log_f + state["m"] - m_new)
    i_s = torch.exp(log_i - m_new)
    c = (f_s[..., None, None] * state["C"]
         + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", c, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))
    h = (num / (den[..., None] + 1e-6)).reshape(b, 1, -1)
    return _mlstm_out(p, h, z, x.dtype), {"C": c, "n": n, "m": m_new}


def init_mlstm_state(batch: int, d_inner: int, n_heads: int, device=None):
    hd = d_inner // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, hd, hd), **f32),
            "n": torch.zeros((batch, n_heads, hd), **f32),
            "m": torch.full((batch, n_heads), M_INIT, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, d_model: int, n_heads: int,
               dtype=torch.float32) -> Params:
    return {
        # Input projections of the gates z, i, f, o (one GEMM).
        "w": init_dense(generator, d_model, 4 * d_model, bias=True,
                        dtype=dtype),
        # Recurrent connections, merged.
        "r": init_dense(generator, d_model, 4 * d_model, bias=False,
                        dtype=dtype),
        "norm": init_rms_norm(d_model, dtype),
        "down": init_dense(generator, d_model, d_model, bias=False,
                           zero_init=True, dtype=dtype),
    }


def _slstm_step(p, wx_t, state):
    """One step. wx_t: (B, 4d) fp32, the input projection."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    gates = wx_t + dense(p["r"], h).float()
    z, i, f, o = gates.chunk(4, dim=-1)
    log_f = _log_sigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    i_s = torch.exp(i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o) * c_new / (n_new + 1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_forward(p: Params, x: torch.Tensor, state=None):
    """A sequential scan over time. x: (B, S, d)."""
    b, s, d = x.shape
    wx = dense(p["w"], x).float()                   # (B, S, 4d)
    if state is None:
        state = init_slstm_state(b, d, device=x.device)
    hs = []
    for t in range(s):
        state = _slstm_step(p, wx[:, t], state)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    return dense(p["down"], rms_norm(p["norm"], h)), state


def slstm_decode(p: Params, x: torch.Tensor, state):
    wx = dense(p["w"], x).float()[:, 0]
    state = _slstm_step(p, wx, state)
    h = state["h"][:, None].to(x.dtype)
    return dense(p["down"], rms_norm(p["norm"], h)), state


def init_slstm_state(batch: int, d: int, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), **f32),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M_INIT, **f32)}
