"""Launch wrapper of the fused softmax CUDA kernel (``csrc/fused_softmax.cu``).

Replaces ``fused_softmax_pallas`` (src/repro/kernels/fused_softmax.py): the
softmax of the scores-materialized attention, ``softmax(scale*x + bias +
mask)`` over the last axis. The wrapper takes CUDA tensors only;
``ops.fused_softmax`` routes CPU tensors to the plain version
``ref.softmax_ref``.

The kernel has two variants behind one launch: for C <= ``MAX_WARP_C``
the rows kernel, whose lanes, vectors and runs of rows ``softmax_partition``
and ``softmax_steps`` choose, and above it a block per row. The checks that
depend only on shapes, strides and dtypes run once per distinct key
(``_softmax_geometry``); those of devices and alignment every call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_C = 16384               # the reference's envelope (_MAX_SOFTMAX_C)
MAX_WARP_C = 1024           # the rows kernel's widest row; a block per row above
WARP = 32
ROWS_IN_FLIGHT = 2          # rows a lane group holds at once (kRows)
MAX_VECTORS_PER_LANE = 8    # 16-byte vectors of a row in one lane
SCALAR_NVL = (1, 2, 4, 8, 16, 32)   # elements a lane, one at a time
MAX_STEPS = 8
# The fewest warps a call's runs are cut into before a run grows: two
# waves of 64 resident warps on each of the H100's 132 SMs, rounded up to a
# power of two.
MIN_WARPS = 16384


def softmax_partition(c: int, itemsize: int,
                      aligned: bool) -> tuple[int, int, int] | None:
    """How the rows kernel splits a row of ``c`` elements of ``itemsize``
    bytes: (lanes a row, vectors a lane, elements a vector), lane l of a row
    holding its vectors l, l + lanes, ...; None above ``MAX_WARP_C`` (a
    block per row).

    16-byte vectors where ``aligned`` (every pointer 16-byte aligned) and C
    is whole vectors: over the largest power of two up to 32 lanes that
    divides the vector count, as K1's ``ln_partition`` splits a row, where
    that leaves at most ``MAX_VECTORS_PER_LANE`` a lane (C = 256 and 128 in
    bf16: one a lane; 384: 16 lanes of three); else over the least power
    of two of lanes, up to 32, that holds them, the vectors past C
    predicated (C = 200 in bf16: 25 vectors on 32 lanes). Otherwise one
    element at a time over the same lanes, the elements a lane rounded up
    to one of ``SCALAR_NVL``."""
    if c > MAX_WARP_C:
        return None
    per_vec = 16 // itemsize
    if aligned and c % per_vec == 0:
        nv = c // per_vec
        lanes = 1
        while lanes < WARP and nv % (2 * lanes) == 0:
            lanes *= 2
        if nv // lanes <= MAX_VECTORS_PER_LANE:
            return lanes, nv // lanes, per_vec
        lanes = min(WARP, 1 << (nv - 1).bit_length())
        return lanes, -(-nv // lanes), per_vec
    lanes = min(WARP, 1 << (c - 1).bit_length())
    need = -(-c // lanes)
    return lanes, next(n for n in SCALAR_NVL if n >= need), 1


def softmax_steps(rows: int, lanes: int) -> int:
    """Pairs of rows each lane group of a warp takes: a warp's run is
    ``steps * ROWS_IN_FLIGHT * (WARP // lanes)`` consecutive rows, as long
    as the call still gives ``MIN_WARPS`` warps, at most ``MAX_STEPS``."""
    per_step = ROWS_IN_FLIGHT * (WARP // lanes)
    return max(1, min(MAX_STEPS, rows // (per_step * MIN_WARPS)))


def softmax_geometry(rows: int, hr: int, rep: int, c: int, dtype_code: int,
                     part) -> tuple[int, ...]:
    """The launch geometry the kernel reads (its ``Geom``): rows, H*R, rep,
    C, dtype code, lanes a row (log2), vectors a lane (0: a block per row),
    elements a vector, steps."""
    if part is None:
        return (rows, hr, rep, c, dtype_code, 0, 0, 1, 1)
    lanes, nvl, vec = part
    return (rows, hr, rep, c, dtype_code, lanes.bit_length() - 1, nvl, vec,
            softmax_steps(rows, lanes))


# (x, bias, mask: shape, stride, dtype) -> (the geometry with 16-byte
# vectors, the geometry one element at a time), each as the ctypes array of
# long longs whose address the kernel's entry point takes.
_SOFTMAX_GEOM: dict = {}


def _softmax_geometry(fn, x, bias, mask, key):
    """The checks that depend only on shapes, layouts and dtypes, made once
    per distinct ``key``; returns the launch geometry, cached under it."""
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
        nb = bias.shape[0] if bias.ndim else 0
        if (bias.ndim != 4 or bias.shape[1:] != (h, r, c) or nb == 0
                or n % nb != 0 or bias.dtype != x.dtype
                or not bias.is_contiguous()):
            raise ValueError(f"{fn}: bias {tuple(bias.shape)} {bias.dtype} must "
                             f"be contiguous (B, {h}, {r}, {c}) in {x.dtype} "
                             "with N % B == 0")
        rep = n // nb
    if mask is not None and (mask.shape != (n, c) or mask.dtype != torch.float32
                             or not mask.is_contiguous()):
        raise ValueError(f"{fn}: mask {tuple(mask.shape)} {mask.dtype} must be "
                         f"contiguous fp32 ({n}, {c})")
    geoms = tuple(
        (ctypes.c_longlong * 9)(*softmax_geometry(
            n * h * r, h * r, rep, c, _build.DTYPE_CODES[x.dtype],
            softmax_partition(c, x.element_size(), aligned)))
        for aligned in (True, False))
    return _build.remember(_SOFTMAX_GEOM, key, geoms)


def _softmax_checked(fn, x, bias, mask):
    """The geometry of a call: cached under the shapes, strides and dtypes
    of its tensors, so that a layout or dtype not seen before is checked."""
    key = (x.shape, x.stride(), x.dtype,
           None if bias is None else (bias.shape, bias.stride(), bias.dtype),
           None if mask is None else (mask.shape, mask.stride(), mask.dtype))
    geom = _SOFTMAX_GEOM.get(key)
    return geom if geom is not None else _softmax_geometry(fn, x, bias, mask,
                                                           key)


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
    vec_geom, scalar_geom = _softmax_checked(fn, x, bias, mask)
    dev = x.get_device()
    xp = x.data_ptr()
    bp = mp = None
    align = xp
    if bias is not None:
        if bias.get_device() != dev:
            raise ValueError(f"{fn}: bias on {bias.device}, not on {x.device}")
        bp = bias.data_ptr()
        align |= bp
    if mask is not None:
        if mask.get_device() != dev:
            raise ValueError(f"{fn}: mask on {mask.device}, not on {x.device}")
        mp = mask.data_ptr()
        align |= mp
    out = torch.empty_like(x)
    # The output is a fresh allocation, so aligned; the inputs may be views.
    err = _build.entry("fused_softmax")(
        xp, bp, mp, out.data_ptr(), vec_geom if align % 16 == 0 else scalar_geom,
        scale, _build.stream_handle(x))
    _build.check("fused_softmax", err)
    return out
