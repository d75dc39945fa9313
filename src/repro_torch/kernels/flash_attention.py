"""Launch wrappers of the flash-attention forward and backward CUDA kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``).

They replace ``flash_attention_pallas`` and ``flash_attention_bwd_pallas``
(src/repro/kernels/flash_attention.py). The kernels read q/k/v (and the
backward's out and do) in the JAX layout (N, S, H, D) through their N and S
strides, so the column slices of the merged QKV projection go in without a
copy; only the innermost (H, D) block must be dense. The wrappers take CUDA
tensors only; ``ops.fused_attention`` routes CPU tensors to the plain
versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32)        # the Evoformer's head dim in MINI and FULL


def supported(n: int, h: int, d: int, skv: int) -> bool:
    """Whether the forward and backward kernels take N rows of H heads of
    head dim D over Skv keys: D in ``HEAD_DIMS``, N and H within the launch
    grid, N and Skv not 0."""
    return (d in HEAD_DIMS and 0 < n <= _build.MAX_GRID_YZ
            and h <= _build.MAX_GRID_YZ and skv > 0)


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
    if n > _build.MAX_GRID_YZ or h > _build.MAX_GRID_YZ or skv == 0:
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


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, bias: torch.Tensor | None,
                             mask: torch.Tensor | None, scale: float,
                             need_dmask: bool = False):
    """The gradients of ``flash_attention_cuda``'s output from its saved
    (q, k, v, out, lse) and the cotangent ``do``.

    q, out, do: (N, Sq, H, D); k, v: (N, Skv, H, D); all one dtype (fp32 or
    bf16), each with a dense (H, D) block. lse: (N, H, Sq) contiguous fp32.
    bias, mask: as for the forward. Returns (dq, dk, dv in q's dtype, dbias
    (B, H, Sq, Skv) in the bias's dtype or None, dmask (N, Skv) fp32 or None;
    dmask only when ``need_dmask`` and there is a mask)."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd_cuda: dtype {q.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    n, sq, h, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_cuda: head dim {d} not in {HEAD_DIMS}")
    if (n > _build.MAX_GRID_YZ or h > _build.MAX_GRID_YZ or skv == 0 or sq == 0
            or n == 0):
        raise ValueError(f"flash_attention_bwd_cuda: N={n}, H={h}, Sq={sq}, "
                         f"Skv={skv} outside the kernel's grid")
    for name, t, s in (("q", q, sq), ("k", k, skv), ("v", v, skv),
                       ("out", out, sq), ("do", do, sq)):
        _check_qkv(name, t, n, h, d)
        if t.shape[1] != s or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {name} {tuple(t.shape)} "
                             f"{t.dtype} does not match q/k")
    if (lse.shape != (n, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd_cuda: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be contiguous fp32 ({n}, {h}, {sq})")
    rep = 1
    if bias is not None:
        nb = bias.shape[0]
        if (bias.ndim != 4 or bias.shape[1:] != (h, sq, skv) or n % nb != 0
                or bias.dtype != q.dtype or bias.device != q.device
                or not bias.is_contiguous()):
            raise ValueError(f"flash_attention_bwd_cuda: bias {tuple(bias.shape)} "
                             f"{bias.dtype} must be contiguous (B, {h}, {sq}, "
                             f"{skv}) in {q.dtype} with N % B == 0")
        rep = n // nb
    if mask is not None and (mask.shape != (n, skv) or mask.dtype != torch.float32
                             or mask.device != q.device
                             or not mask.is_contiguous()):
        raise ValueError(f"flash_attention_bwd_cuda: mask {tuple(mask.shape)} "
                         f"{mask.dtype} must be contiguous fp32 ({n}, {skv})")
    dev, f32 = q.device, torch.float32
    dq = torch.empty((n, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((n, skv, h, d), dtype=q.dtype, device=dev)
    dv = torch.empty((n, skv, h, d), dtype=q.dtype, device=dev)
    delta = torch.empty((n, h, sq), dtype=f32, device=dev)
    dbias = torch.empty_like(bias) if bias is not None else None
    dmask = dmask_h = None
    if need_dmask and mask is not None:
        dmask = torch.empty((n, skv), dtype=f32, device=dev)
        dmask_h = torch.empty((n, h, skv), dtype=f32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = _build.entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), ptr(bias), ptr(mask), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ptr(dbias), ptr(dmask), delta.data_ptr(), ptr(dmask_h),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), out.stride(0), out.stride(1), do.stride(0), do.stride(1),
        n, sq, skv, h, d, rep, float(scale), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv, dbias, dmask
