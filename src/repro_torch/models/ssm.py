"""Selective state-space (Mamba-style) block, used by the Hymba hybrid arch:
the port of the reference's ``models/ssm.py``, plain PyTorch as the
reference's is plain JAX.

The scan. The reference runs the recurrence h_t = a_t h_{t-1} + bx_t as a
``jax.lax.associative_scan`` over time. The port runs it as a sequential
loop over time in fp32, the same step ``mamba_decode`` takes, so a
prefill and the same tokens decoded one at a time agree to the bit in
the state; it rounds differently from the associative scan by a few
fp32 ulps, inside the module tolerance, and so do its gradients against
the reference's differentiated associative scan. The states are kept in
a list and stacked once, so that autograd sees one node a step, not an
in-place write into the whole (B, S, d_inner, n) tensor a step. ``a``
and ``bx`` are fp32 (B, S, d_inner, n): at hymba-1.5b's full width
(d_inner 3200, n 16) that is 52 MB each a batch row at S = 256.

The conv state comes out of a prefill in the compute dtype and is kept
in fp32 in the cache (``init_mamba_state``); the serving engine's slot
copy casts it, and decode casts it back to the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.layers.params import Params, dense, init_dense, trunc_normal


def init_mamba(generator: torch.Generator, d_model: int, ssm: SSMConfig,
               d_inner: int | None = None, dtype=torch.float32) -> Params:
    d_inner = d_inner or ssm.expand * d_model
    dt_rank = ssm.dt_rank or max(1, d_model // 16)
    a = torch.arange(1, ssm.state_dim + 1, dtype=dtype)
    return {
        "in_proj": init_dense(generator, d_model, 2 * d_inner, bias=False,
                              dtype=dtype),
        "conv_w": trunc_normal(generator, (ssm.conv_width, d_inner), 1.0,
                               dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype),
        "x_proj": init_dense(generator, d_inner, dt_rank + 2 * ssm.state_dim,
                             bias=False, dtype=dtype),
        "dt_proj": init_dense(generator, dt_rank, d_inner, bias=True,
                              dtype=dtype),
        # A = -[1..state] (S4D-real), stored as its log.
        "A_log": torch.log(a).expand(d_inner, ssm.state_dim).clone(),
        "D": torch.ones((d_inner,), dtype=dtype),
        "out_proj": init_dense(generator, d_inner, d_model, bias=False,
                               zero_init=True, dtype=dtype),
    }


def _ssm_params(p, x_in, ssm: SSMConfig):
    """x_in: (B, S, d_inner) after the conv. Returns the discretised a,
    bx (fp32 (B, S, d_inner, n)), C (fp32 (B, S, n)) and D."""
    dt_rank = p["dt_proj"]["w"].shape[0]
    proj = dense(p["x_proj"], x_in)
    dt, b_in, c_out = proj.split([dt_rank, ssm.state_dim, ssm.state_dim],
                                 dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt).float())          # (B, S, di)
    a_mat = -torch.exp(p["A_log"])                            # (di, n)
    a = torch.exp(dt[..., None] * a_mat)
    bx = (dt * x_in.float())[..., None] * b_in[:, :, None, :].float()
    return a, bx, c_out.float(), p["D"]


def _conv1d(p, x, ssm: SSMConfig, conv_state=None):
    """Causal depthwise conv; x (B, S, di). Returns (y, new conv state),
    the state the last ``conv_width - 1`` inputs in x's dtype."""
    w = p["conv_w"].to(x.dtype)                               # (W, di)
    kw = ssm.conv_width
    if conv_state is None:
        pad = torch.zeros((x.shape[0], kw - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # (B, S+W-1, di)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, kw):
        y = y + xp[:, i:i + s] * w[i]
    y = y + p["conv_b"].to(x.dtype)
    return y, xp[:, -(kw - 1):]


def _in_and_gate(p, x, ssm: SSMConfig, conv_state=None):
    xz = dense(p["in_proj"], x)
    x_in, z = xz.chunk(2, dim=-1)
    x_c, conv_state = _conv1d(p, x_in, ssm, conv_state)
    x_c = F.silu(x_c.float()).to(x.dtype)
    return x_c, z, conv_state


def _out(p, y, x_c, z, d_skip, dtype):
    y = y + d_skip * x_c.float()
    y = y * F.silu(z.float())
    return dense(p["out_proj"], y.to(dtype))


def mamba_forward(p: Params, x: torch.Tensor, ssm: SSMConfig):
    """Full-sequence forward (train and prefill). x: (B, S, d). Returns
    (y (B, S, d), state {"h": (B, di, n) fp32, "conv": (B, W-1, di)})."""
    x_c, z, conv_state = _in_and_gate(p, x, ssm)
    a, bx, c_out, d_skip = _ssm_params(p, x_c, ssm)
    hs = [bx[:, 0]]
    for t in range(1, x.shape[1]):
        hs.append(a[:, t] * hs[-1] + bx[:, t])
    h_t = hs[-1]
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), c_out)
    return _out(p, y, x_c, z, d_skip, x.dtype), {"h": h_t, "conv": conv_state}


def mamba_decode(p: Params, x: torch.Tensor, state, ssm: SSMConfig):
    """One step. x: (B, 1, d); state {"h": (B, di, n), "conv"}."""
    x_c, z, conv_state = _in_and_gate(p, x, ssm, state["conv"])
    a, bx, c_out, d_skip = _ssm_params(p, x_c, ssm)
    h = a[:, 0] * state["h"] + bx[:, 0]                       # (B, di, n)
    y = torch.einsum("bdn,bn->bd", h, c_out[:, 0])[:, None]
    return _out(p, y, x_c, z, d_skip, x.dtype), {"h": h, "conv": conv_state}


def init_mamba_state(batch: int, d_inner: int, ssm: SSMConfig, device=None):
    return {
        "h": torch.zeros((batch, d_inner, ssm.state_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, ssm.conv_width - 1, d_inner),
                            dtype=torch.float32, device=device),
    }
