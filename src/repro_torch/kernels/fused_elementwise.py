"""Launch wrappers of the gating and the bias-dropout-add CUDA kernels
(``csrc/bias_sigmoid_mul.cu``, ``csrc/bias_dropout_add.cu``).

They replace ``bias_sigmoid_mul_pallas`` and ``bias_dropout_add_pallas``
(src/repro/kernels/fused_elementwise.py). The wrappers take CUDA tensors
only; ``ops.bias_sigmoid_mul`` and ``ops.bias_dropout_add`` route CPU tensors
to the plain versions. The gating kernel has two variants behind one
launch, 16-byte vectors and one element at a time (``gate_partition``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


WARP = 32


def gate_partition(c: int, itemsize: int, aligned: bool) -> tuple[int, int]:
    """How the gating kernel covers a row of ``c`` channels: (elements a
    vector, threads a row). 16-byte vectors (8 bf16, 4 fp32) where
    ``aligned`` (every pointer 16-byte aligned) and C is whole vectors,
    else one element at a time; over the least power of two of threads, up
    to 32, that holds the row's vectors (32 at C = 256 and 16 at C = 128
    in bf16), thread t of a row taking its vectors t, t + threads, ..."""
    per_vec = 16 // itemsize
    vec = per_vec if aligned and c % per_vec == 0 else 1
    return vec, min(WARP, 1 << (c // vec - 1).bit_length())


# (g, bg, v: shape, stride, dtype) -> (rows, C, dtype code, the vector
# partition, the scalar partition), each partition (elements a vector,
# threads a row as log2).
_BSM_GEOM: dict = {}


def _bsm_geometry(fn, g, bg, v, key):
    """The checks that depend only on shapes, layouts and dtypes, made once
    per distinct ``key``; returns the launch geometry, cached under it."""
    c = v.shape[-1] if v.ndim else 0
    if v.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {v.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if g.shape != v.shape or g.dtype != v.dtype:
        raise ValueError(f"{fn}: g {tuple(g.shape)} {g.dtype} must match v "
                         f"{tuple(v.shape)} {v.dtype}")
    if not (g.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{fn}: g and v must be contiguous")
    if (c <= 0 or bg.shape != (c,) or bg.dtype != torch.float32
            or not bg.is_contiguous()):
        raise ValueError(f"{fn}: bg must be a contiguous fp32 ({c},) tensor")
    parts = []
    for aligned in (True, False):
        vec, threads = gate_partition(c, v.element_size(), aligned)
        parts.append((vec, threads.bit_length() - 1))
    return _build.remember(_BSM_GEOM, key, (
        v.numel() // c, c, _build.DTYPE_CODES[v.dtype], *parts))


def _bsm_checked(fn, g, bg, v):
    """The geometry of a call: cached under the shapes, strides and dtypes
    of its tensors, so that a layout or dtype not seen before is checked."""
    key = (g.shape, g.stride(), g.dtype, bg.shape, bg.stride(), bg.dtype,
           v.shape, v.stride(), v.dtype)
    geom = _BSM_GEOM.get(key)
    return geom if geom is not None else _bsm_geometry(fn, g, bg, v, key)


def bias_sigmoid_mul_cuda(g: torch.Tensor, bg: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v: g and v contiguous CUDA tensors of one shape and
    dtype (fp32 or bf16), bg a (C,) fp32 tensor on the same device. Output
    in v's dtype. The checks that depend only on shapes, strides and dtypes
    run once per distinct combination (``_bsm_geometry``); those of devices
    and alignment (16-byte vectors, or one element at a time) every call."""
    fn = "bias_sigmoid_mul_cuda"
    if not v.is_cuda:
        raise ValueError(f"{fn} needs a CUDA tensor, got {v.device}")
    rows, c, code, vec_part, scalar_part = _bsm_checked(fn, g, bg, v)
    dev = v.get_device()
    if g.get_device() != dev or bg.get_device() != dev:
        raise ValueError(f"{fn}: g and bg must be on {v.device}")
    gp, bp, vp = g.data_ptr(), bg.data_ptr(), v.data_ptr()
    # The output is a fresh allocation, so aligned.
    vec, lanes_log2 = vec_part if not (gp | bp | vp) % 16 else scalar_part
    out = torch.empty_like(v)
    err = _build.entry("bias_sigmoid_mul")(
        gp, bp, vp, out.data_ptr(), rows, c, vec, lanes_log2, code,
        _build.stream_handle(v))
    _build.check("bias_sigmoid_mul", err)
    return out


KEEP_DTYPE_CODES = {torch.float32: 0, torch.uint8: 1, torch.bool: 1}
# The largest y and z extents of the kernel's grid, which hold d1 and d0.
_MAX_D01 = 65535


def broadcast_strides(shape, keep_shape, keep_stride) -> tuple[int, ...]:
    """The strides of a mask of ``keep_shape`` and ``keep_stride`` broadcast
    to ``shape``, as ``keep.expand(shape).stride()`` gives them (0 along an
    axis of size 1 that grows, and along every leading axis the mask
    lacks), without building the view. Raises ValueError where the mask
    does not broadcast."""
    lead = len(shape) - len(keep_shape)
    if lead < 0:
        raise ValueError(f"keep {tuple(keep_shape)} has more dims than "
                         f"{tuple(shape)}: it does not broadcast")
    out = [0] * lead
    for n, k, st in zip(shape[lead:], keep_shape, keep_stride):
        if k == n:
            out.append(st)
        elif k == 1:
            out.append(0)
        else:
            raise ValueError(f"keep {tuple(keep_shape)} does not broadcast "
                             f"to {tuple(shape)}")
    return tuple(out)


# (shape, dtype[, keep shape, keep strides, keep dtype]) -> the launch
# geometry as the kernel reads it (d0, d1, d2, C, the mask's four strides,
# dtype code, mask dtype code), held as a ctypes array whose address the
# kernel's entry point takes.
_BDA_GEOM: dict = {}


def _bda_geometry(fn, residual, keep, key):
    """The checks that depend only on shapes, layouts and dtypes, made once
    per distinct ``key``; returns the geometry, cached under it."""
    shape = residual.shape
    if residual.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {residual.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if not 1 <= residual.ndim <= 4 or shape[-1] % 8:
        raise ValueError(f"{fn}: shape {tuple(shape)} needs 1 to 4 dims and "
                         "C % 8 == 0")
    dims = (1,) * (4 - residual.ndim) + tuple(shape)
    if dims[0] > _MAX_D01 or dims[1] > _MAX_D01:
        raise ValueError(f"{fn}: shape {tuple(shape)}: the two leading dims "
                         f"of its 4-dim view {dims} exceed the grid's "
                         f"{_MAX_D01}")
    kstrides, keep_code = (0, 0, 0, 0), 0
    if keep is not None:
        if keep.dtype not in KEEP_DTYPE_CODES:
            raise TypeError(f"{fn}: keep {keep.dtype} is not one of "
                            f"{tuple(KEEP_DTYPE_CODES)}")
        kstrides = (0,) * (4 - residual.ndim) + broadcast_strides(
            shape, keep.shape, keep.stride())
        keep_code = KEEP_DTYPE_CODES[keep.dtype]
    geom = (ctypes.c_longlong * 10)(*dims, *kstrides,
                                     _build.DTYPE_CODES[residual.dtype],
                                     keep_code)
    return _build.remember(_BDA_GEOM, key, geom)


def bias_dropout_add_cuda(x: torch.Tensor, b: torch.Tensor | None,
                          residual: torch.Tensor, keep: torch.Tensor | None,
                          rate: float) -> torch.Tensor:
    """residual + keep * (x + b) / (1 - rate), summed in fp32, in the
    residual's dtype. x and residual: contiguous CUDA tensors of one shape
    (at most 4 dims, the first two of the 4-dim view at most 65535, C % 8 ==
    0, 16-byte aligned) and dtype (fp32 or bf16); b: a (C,) fp32 tensor or
    None; keep: None (no dropout), or a 0/1 mask (fp32, uint8 or bool) on
    the same device that broadcasts against x, typically at the reduced
    shape with the shared axis of size 1, read through broadcast strides.

    The checks that depend only on shapes, strides and dtypes run once per
    distinct combination (``_bda_geometry``); those of devices, contiguity
    and alignment run every call."""
    fn = "bias_dropout_add_cuda"
    if not residual.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, got {residual.device}")
    shape, dt = residual.shape, residual.dtype
    key = ((shape, dt) if keep is None else
           (shape, dt, keep.shape, keep.stride(), keep.dtype))
    geom = _BDA_GEOM.get(key)
    if geom is None:
        geom = _bda_geometry(fn, residual, keep, key)
    dev = residual.get_device()
    if x.shape != shape or x.dtype != dt or x.get_device() != dev:
        raise ValueError(f"{fn}: x {tuple(x.shape)} {x.dtype} must match the "
                         f"residual {tuple(shape)} {dt}")
    xp, rp = x.data_ptr(), residual.data_ptr()
    if (not (x.is_contiguous() and residual.is_contiguous())
            or (xp | rp) % 16):
        raise ValueError(f"{fn}: x and the residual must be contiguous and "
                         "16-byte aligned")
    bp = kp = None
    if b is not None:
        if (b.shape != (shape[-1],) or b.dtype != torch.float32
                or b.get_device() != dev or not b.is_contiguous()):
            raise ValueError(f"{fn}: b must be a contiguous fp32 "
                             f"({shape[-1]},) tensor on {residual.device}")
        bp = b.data_ptr()
    if keep is not None:
        if not 0.0 < rate < 1.0:
            raise ValueError(f"{fn}: rate {rate} outside (0, 1)")
        if keep.get_device() != dev:
            raise ValueError(f"{fn}: keep on {keep.device}, not on "
                             f"{residual.device}")
        kp = keep.data_ptr()
    elif rate != 0.0:
        raise ValueError(f"{fn}: rate {rate} needs a keep mask")
    out = torch.empty_like(residual)
    err = _build.entry("bias_dropout_add")(
        xp, bp, rp, kp, out.data_ptr(), geom, 1.0 - rate,
        _build.stream_handle(residual))
    _build.check("bias_dropout_add", err)
    return out
