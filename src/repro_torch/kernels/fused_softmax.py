"""Launch wrapper of the fused softmax CUDA kernel (``csrc/fused_softmax.cu``).

Replaces ``fused_softmax_pallas`` (src/repro/kernels/fused_softmax.py): the
softmax of the scores-materialized attention, ``softmax(scale*x + bias +
mask)`` over the last axis. The wrapper takes CUDA tensors only;
``ops.fused_softmax`` routes CPU tensors to the plain version
``ref.softmax_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_C = 16384               # the reference's envelope (_MAX_SOFTMAX_C)


def fused_softmax_cuda(x: torch.Tensor, bias: torch.Tensor | None,
                       mask: torch.Tensor | None,
                       scale: float = 1.0) -> torch.Tensor:
    """x: (N, H, R, C) contiguous, fp32 or bf16; bias: (B, H, R, C)
    contiguous in x's dtype with N % B == 0 (bias row n // (N/B)), or None;
    mask: (N, C) contiguous fp32 additive, or None. C <= ``MAX_C``.
    Returns softmax(scale*x + bias + mask) over C in x's dtype."""
    fn = "fused_softmax_cuda"
    if not x.is_cuda:
        raise ValueError(f"{fn} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {x.dtype} not in {tuple(_build.DTYPE_CODES)}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{fn}: x {tuple(x.shape)} must be a contiguous "
                         "(N, H, R, C) tensor")
    n, h, r, c = x.shape
    if not 0 < c <= MAX_C:
        raise ValueError(f"{fn}: C={c} outside (0, {MAX_C}]")
    rep = 1
    if bias is not None:
        nb = bias.shape[0]
        if (bias.ndim != 4 or bias.shape[1:] != (h, r, c) or nb == 0
                or n % nb != 0 or bias.dtype != x.dtype
                or bias.device != x.device or not bias.is_contiguous()):
            raise ValueError(f"{fn}: bias {tuple(bias.shape)} {bias.dtype} must "
                             f"be contiguous (B, {h}, {r}, {c}) in {x.dtype} "
                             "with N % B == 0")
        rep = n // nb
    if mask is not None and (mask.shape != (n, c) or mask.dtype != torch.float32
                             or mask.device != x.device
                             or not mask.is_contiguous()):
        raise ValueError(f"{fn}: mask {tuple(mask.shape)} {mask.dtype} must be "
                         f"contiguous fp32 ({n}, {c})")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in (x, bias, mask, out) if t is not None]
    err = _build.entry("fused_softmax")(
        x.data_ptr(), bias.data_ptr() if bias is not None else None,
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        n * h * r, h * r, rep, c, float(scale), _build.DTYPE_CODES[x.dtype],
        int(all(p % 16 == 0 for p in ptrs)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_softmax", err)
    return out
