"""Launch wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention_fwd.cu``).

Replaces ``flash_attention_pallas`` (src/repro/kernels/flash_attention.py).
The kernel reads q/k/v in the JAX layout (N, S, H, D) through their N and S
strides, so the column slices of the merged QKV projection go in without a
copy; only the innermost (H, D) block must be dense. The wrapper takes CUDA
tensors only; ``ops.fused_attention`` routes CPU tensors to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32)        # the Evoformer's head dim in MINI and FULL
MAX_GRID_YZ = 65535


def _check_qkv(name: str, t: torch.Tensor, n: int, h: int, d: int):
    if t.ndim != 4 or t.shape[0] != n or t.shape[2] != h or t.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: {name} {tuple(t.shape)} is not "
                         f"(N={n}, S, H={h}, D={d})")
    if t.stride(3) != 1 or t.stride(2) != d:
        raise ValueError(f"flash_attention_cuda: {name} needs a dense (H, D) "
                         f"block, strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None, mask: torch.Tensor | None,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (N, Sq, H, D); k, v: (N, Skv, H, D), fp32 or bf16, all one dtype.
    bias: (B, H, Sq, Skv) contiguous in q's dtype with N % B == 0, or None.
    mask: (N, Skv) contiguous fp32 additive, or None.
    Returns (out (N, Sq, H, D) in q's dtype, lse (N, H, Sq) fp32)."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    n, sq, h, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in {HEAD_DIMS}")
    if n > MAX_GRID_YZ or h > MAX_GRID_YZ or skv == 0:
        raise ValueError(f"flash_attention_cuda: N={n}, H={h}, Skv={skv} outside "
                         "the kernel's grid")
    _check_qkv("q", q, n, h, d)
    for name, t in (("k", k), ("v", v)):
        _check_qkv(name, t, n, h, d)
        if t.shape[1] != skv or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} {tuple(t.shape)} "
                             f"{t.dtype} does not match k/q")
    rep = 1
    if bias is not None:
        nb = bias.shape[0]
        if (bias.ndim != 4 or bias.shape[1:] != (h, sq, skv) or n % nb != 0
                or bias.dtype != q.dtype or bias.device != q.device
                or not bias.is_contiguous()):
            raise ValueError(f"flash_attention_cuda: bias {tuple(bias.shape)} "
                             f"{bias.dtype} must be contiguous (B, {h}, {sq}, "
                             f"{skv}) in {q.dtype} with N % B == 0")
        rep = n // nb
    if mask is not None and (mask.shape != (n, skv) or mask.dtype != torch.float32
                             or mask.device != q.device
                             or not mask.is_contiguous()):
        raise ValueError(f"flash_attention_cuda: mask {tuple(mask.shape)} "
                         f"{mask.dtype} must be contiguous fp32 ({n}, {skv})")
    out = torch.empty((n, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, sq), dtype=torch.float32, device=q.device)
    err = _build.entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        mask.data_ptr() if mask is not None else None,
        out.data_ptr(), lse.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), n, sq, skv, h, d, rep, float(scale),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_fwd", err)
    return out, lse
