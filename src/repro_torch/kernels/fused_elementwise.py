"""Launch wrapper of the gating CUDA kernel (``csrc/bias_sigmoid_mul.cu``).

Replaces ``bias_sigmoid_mul_pallas`` (src/repro/kernels/fused_elementwise.py).
The wrapper takes CUDA tensors only; ``ops.bias_sigmoid_mul`` routes CPU
tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bias_sigmoid_mul_cuda(g: torch.Tensor, bg: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v: g and v contiguous CUDA tensors of one shape and
    dtype (fp32 or bf16), bg a (C,) fp32 tensor. Output in v's dtype."""
    c = v.shape[-1]
    if not v.is_cuda:
        raise ValueError(f"bias_sigmoid_mul_cuda needs a CUDA tensor, got {v.device}")
    if v.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"bias_sigmoid_mul_cuda: dtype {v.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if g.shape != v.shape or g.dtype != v.dtype or g.device != v.device:
        raise ValueError(f"bias_sigmoid_mul_cuda: g {tuple(g.shape)} {g.dtype} "
                         f"must match v {tuple(v.shape)} {v.dtype}")
    if not (g.is_contiguous() and v.is_contiguous()):
        raise ValueError("bias_sigmoid_mul_cuda: g and v must be contiguous")
    if (bg.shape != (c,) or bg.dtype != torch.float32 or bg.device != v.device
            or not bg.is_contiguous()):
        raise ValueError(f"bias_sigmoid_mul_cuda: bg must be a contiguous fp32 "
                         f"({c},) tensor on {v.device}")
    out = torch.empty_like(v)
    err = _build.entry("bias_sigmoid_mul")(
        g.data_ptr(), bg.data_ptr(), v.data_ptr(), out.data_ptr(), v.numel(),
        c, _build.DTYPE_CODES[v.dtype],
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check("bias_sigmoid_mul", err)
    return out
