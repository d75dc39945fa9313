"""Feed-forward blocks: SwiGLU and the GELU MLP (decoder LMs), and the
Evoformer Transition (LN -> Linear(4x) -> ReLU -> Linear; the LN lives in
the caller)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.params import Params, dense, init_dense


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> Params:
    return {
        # Merge-GEMM: gate and up projections in one weight.
        "wi": init_dense(generator, d_model, 2 * d_ff, bias=False,
                         dtype=dtype),
        "wo": init_dense(generator, d_ff, d_model, bias=False,
                         zero_init=True, dtype=dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g, u = (x @ p["wi"]["w"].to(dt)).chunk(2, dim=-1)
    h = F.silu(g.float()).to(dt) * u
    return h @ p["wo"]["w"].to(dt)


def init_gelu_mlp(generator: torch.Generator, d_model: int, d_ff: int, *,
                  bias: bool = True, dtype=torch.float32) -> Params:
    return {
        "wi": init_dense(generator, d_model, d_ff, bias=bias, dtype=dtype),
        "wo": init_dense(generator, d_ff, d_model, bias=bias, zero_init=True,
                         dtype=dtype),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximated GELU, computed in fp32 as the reference's
    ``jax.nn.gelu(..., approximate=True)``."""
    h = dense(p["wi"], x)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(p["wo"], h)


def init_transition(generator: torch.Generator, d: int, factor: int = 4,
                    dtype=torch.float32) -> Params:
    return {
        "wi": init_dense(generator, d, factor * d, bias=True, dtype=dtype),
        "wo": init_dense(generator, factor * d, d, bias=True, zero_init=True,
                         dtype=dtype),
    }


def transition(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["wo"], torch.relu(dense(p["wi"], x)))
