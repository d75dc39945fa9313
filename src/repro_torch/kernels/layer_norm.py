"""Launch wrapper of the LayerNorm CUDA kernel (``csrc/layer_norm.cu``).

Replaces ``layer_norm_pallas`` (src/repro/kernels/layer_norm.py). The
wrapper takes CUDA tensors only; ``ops.layer_norm`` routes CPU tensors to
the plain version.

The kernel has two variants behind one launch: rows of 16-byte vectors
held in registers (``ln_partition`` says how a row is split over lanes),
and a loop over the row for every other width. The checks that depend
only on shapes, strides and dtypes run once per distinct key
(``_ln_geometry``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_C = 32768
# The vector kernel's register envelope: at most this many 16-byte vectors
# of a row in one lane.
MAX_VECTORS_PER_LANE = 8
WARP = 32


def ln_partition(c: int, itemsize: int) -> tuple[int, int, int] | None:
    """How the vector kernel splits a row of ``c`` elements of ``itemsize``
    bytes: (lanes a row, 16-byte vectors a lane, elements a vector), lane l
    of a row holding its vectors l, l + lanes, ...; or None where the row is
    not whole vectors or needs more than ``MAX_VECTORS_PER_LANE`` a lane (the
    loop kernel then runs). The lanes a row are the largest power of two up
    to 32 that divides the vector count, so 32 / lanes rows share a warp."""
    per_vec = 16 // itemsize
    if c <= 0 or c % per_vec:
        return None
    nv = c // per_vec
    lanes = 1
    while lanes < WARP and nv % (2 * lanes) == 0:
        lanes *= 2
    if nv // lanes > MAX_VECTORS_PER_LANE:
        return None
    return lanes, nv // lanes, per_vec


# (x shape, stride, dtype, and gamma's and beta's) -> (rows, C, dtype code,
# the vector partition or None).
_LN_GEOM: dict = {}


def _ln_geometry(fn, x, gamma, beta, key):
    """The checks that depend only on shapes, layouts and dtypes, made once
    per distinct ``key``; returns the launch geometry, cached under it."""
    c = x.shape[-1] if x.ndim else 0
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {x.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    if not 0 < c <= MAX_C:
        raise ValueError(f"{fn}: C={c} outside (0, {MAX_C}]")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.shape != (c,) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous fp32 ({c},) "
                             "tensor")
    part = ln_partition(c, x.element_size())
    return _build.remember(_LN_GEOM, key, (x.numel() // c, c,
                                           _build.DTYPE_CODES[x.dtype], part))


def _ln_checked(fn, x, gamma, beta):
    """The geometry of a call: cached under the shapes, strides and dtypes
    of its tensors, so that a layout or dtype not seen before is checked."""
    key = (x.shape, x.stride(), x.dtype, gamma.shape, gamma.stride(),
           gamma.dtype, beta.shape, beta.stride(), beta.dtype)
    geom = _LN_GEOM.get(key)
    return geom if geom is not None else _ln_geometry(fn, x, gamma, beta, key)


def layer_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous CUDA tensor (fp32 or
    bf16); gamma and beta are (C,) fp32 on the same device. Output in x's
    dtype."""
    fn = "layer_norm_cuda"
    if not x.is_cuda:
        raise ValueError(f"{fn} needs a CUDA tensor, got {x.device}")
    rows, c, code, part = _ln_checked(fn, x, gamma, beta)
    dev = x.get_device()
    if gamma.get_device() != dev or beta.get_device() != dev:
        raise ValueError(f"{fn}: gamma and beta must be on {x.device}")
    out = torch.empty_like(x)
    xp, gp, bp = x.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    lpr_log2, nvl = 0, 0
    if part is not None and not (xp | gp | bp) % 16:
        lpr_log2, nvl = part[0].bit_length() - 1, part[1]
    err = _build.entry("layer_norm")(
        xp, gp, bp, out.data_ptr(), rows, c, float(eps), lpr_log2, nvl, code,
        _build.stream_handle(x))
    _build.check("layer_norm", err)
    return out
