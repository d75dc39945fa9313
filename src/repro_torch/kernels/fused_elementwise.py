"""Launch wrappers of the gating and the bias-dropout-add CUDA kernels
(``csrc/bias_sigmoid_mul.cu``, ``csrc/bias_dropout_add.cu``).

They replace ``bias_sigmoid_mul_pallas`` and ``bias_dropout_add_pallas``
(src/repro/kernels/fused_elementwise.py). The wrappers take CUDA tensors
only; ``ops.bias_sigmoid_mul`` and ``ops.bias_dropout_add`` route CPU tensors
to the plain versions.
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


KEEP_DTYPE_CODES = {torch.float32: 0, torch.uint8: 1, torch.bool: 1}


def bias_dropout_add_cuda(x: torch.Tensor, b: torch.Tensor | None,
                          residual: torch.Tensor, keep: torch.Tensor | None,
                          rate: float) -> torch.Tensor:
    """residual + keep * (x + b) / (1 - rate), summed in fp32, in the
    residual's dtype. x and residual: contiguous CUDA tensors of one shape
    (at most 4 dims, C % 8 == 0, 16-byte aligned) and dtype (fp32 or bf16);
    b: a (C,) fp32 tensor or None; keep: None (no dropout), or a 0/1 mask
    (fp32, uint8 or bool) that broadcasts against x, typically at the reduced
    shape with the shared axis of size 1, read through broadcast strides."""
    fn = "bias_dropout_add_cuda"
    if not residual.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, got {residual.device}")
    if residual.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {residual.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    shape, dev = residual.shape, residual.device
    if x.shape != shape or x.dtype != residual.dtype or x.device != dev:
        raise ValueError(f"{fn}: x {tuple(x.shape)} {x.dtype} must match the "
                         f"residual {tuple(shape)} {residual.dtype}")
    if not 1 <= residual.ndim <= 4 or shape[-1] % 8:
        raise ValueError(f"{fn}: shape {tuple(shape)} needs 1 to 4 dims and "
                         "C % 8 == 0")
    for name, t in (("x", x), ("residual", residual)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             "aligned")
    c = shape[-1]
    if b is not None and (b.shape != (c,) or b.dtype != torch.float32
                          or b.device != dev or not b.is_contiguous()):
        raise ValueError(f"{fn}: b must be a contiguous fp32 ({c},) tensor on "
                         f"{dev}")
    dims = (1,) * (4 - residual.ndim) + tuple(shape)
    kstrides = (0, 0, 0, 0)
    keep_code = 0
    if keep is not None:
        if not 0.0 < rate < 1.0:
            raise ValueError(f"{fn}: rate {rate} outside (0, 1)")
        if keep.dtype not in KEEP_DTYPE_CODES or keep.device != dev:
            raise TypeError(f"{fn}: keep {keep.dtype} on {keep.device} is not "
                            f"one of {tuple(KEEP_DTYPE_CODES)} on {dev}")
        try:
            ke = keep.expand(shape)
        except RuntimeError as e:
            raise ValueError(f"{fn}: keep {tuple(keep.shape)} does not "
                             f"broadcast to {tuple(shape)}") from e
        kstrides = (0,) * (4 - residual.ndim) + tuple(ke.stride())
        keep_code = KEEP_DTYPE_CODES[keep.dtype]
    elif rate != 0.0:
        raise ValueError(f"{fn}: rate {rate} needs a keep mask")
    out = torch.empty_like(residual)
    err = _build.entry("bias_dropout_add")(
        x.data_ptr(), b.data_ptr() if b is not None else None,
        residual.data_ptr(), keep.data_ptr() if keep is not None else None,
        out.data_ptr(), dims[0], dims[1], dims[2], c, *kstrides,
        float(1.0 - rate), _build.DTYPE_CODES[residual.dtype], keep_code,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("bias_dropout_add", err)
    return out
