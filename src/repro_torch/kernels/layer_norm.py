"""Launch wrapper of the LayerNorm CUDA kernel (``csrc/layer_norm.cu``).

Replaces ``layer_norm_pallas`` (src/repro/kernels/layer_norm.py). The
wrapper takes CUDA tensors only; ``ops.layer_norm`` routes CPU tensors to
the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_C = 32768


def layer_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous CUDA tensor (fp32 or
    bf16); gamma and beta are (C,) fp32. Output in x's dtype."""
    c = x.shape[-1]
    if not x.is_cuda:
        raise ValueError(f"layer_norm_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"layer_norm_cuda: dtype {x.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_cuda: x must be contiguous")
    if not 0 < c <= MAX_C:
        raise ValueError(f"layer_norm_cuda: C={c} outside (0, {MAX_C}]")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm_cuda: {name} must be a contiguous "
                             f"fp32 ({c},) tensor on {x.device}")
    out = torch.empty_like(x)
    err = _build.entry("layer_norm")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        x.numel() // c, c, float(eps), _build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("layer_norm", err)
    return out
