"""Launch wrappers of the flash-attention forward and backward CUDA kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``).

They replace ``flash_attention_pallas`` and ``flash_attention_bwd_pallas``
(src/repro/kernels/flash_attention.py). The kernels read q/k/v (and the
backward's out and do) in the JAX layout (N, S, H, D) through their N and S
strides, so the column slices of the merged QKV projection go in without a
copy; only the innermost (H, D) block must be dense. The wrappers take CUDA
tensors only; ``ops.fused_attention`` routes CPU tensors to the plain
versions.

The bf16 kernels run on tensor cores over tiles of ``TILE`` query rows and
keys, with 16-byte asynchronous copies, and a block runs G consecutive
groups n of one bias batch over one staged bias slice. Above ``MAX_STAGED``
padded keys the forward streams the bias a tile at a time instead, and a
block runs its G groups side by side over each bias tile (``streamed``).
The host-side choices around them are the plain functions below:
``fwd_groups`` and ``bwd_groups`` (G), ``dbias_partials_shape`` (the
backward's fp32 scratch) and ``copy_for_kernel`` (which strided views are
copied first).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32)        # the Evoformer's head dim in MINI and FULL
TILE = 64                   # bf16 kernels: query rows / keys per block and tile
MAX_STAGED = 384            # widest bias slice (Sq or Skv padded to TILE) staged
GROUP_CHOICES = (8, 4, 2, 1)
STREAM_GROUP_CHOICES = (2, 1)      # the forward's streamed bias: 4 warps a group
MAX_SMEM = 227 * 1024       # shared memory a block may ask for
# Least grid a choice of G may leave, from blocks per SM x 132 SMs: the
# forward's block stages 21 KB + its bias slice (4 blocks an SM at r = 256,
# so about two waves); the backward's dq block also holds an fp32 slab of
# the bias gradient (one 16-warp block an SM, so about four waves).
FWD_MIN_BLOCKS = 1024
BWD_MIN_BLOCKS = 512


def supported(n: int, h: int, d: int, skv: int) -> bool:
    """Whether the forward and backward kernels take N rows of H heads of
    head dim D over Skv keys: D in ``HEAD_DIMS``, N and H within the launch
    grid, N and Skv not 0."""
    return (d in HEAD_DIMS and 0 < n <= _build.MAX_GRID_YZ
            and h <= _build.MAX_GRID_YZ and skv > 0)


def _tiles(s: int) -> int:
    return -(-s // TILE)


def groups_per_block(rep: int, blocks: int, min_blocks: int) -> int:
    """G: the largest of ``GROUP_CHOICES`` that divides ``rep`` (so a block's
    groups share one bias batch) and leaves at least ``min_blocks`` of the
    ``blocks`` a grid has at G = 1; 1 if none does."""
    for g in GROUP_CHOICES:
        if rep % g == 0 and blocks // g >= min_blocks:
            return g
    return 1


def streamed(skv: int, rep: int | None) -> bool:
    """Whether the bf16 forward streams its bias a tile at a time: there is
    a bias and its (TILE x Skv) slice is too wide to stage whole."""
    return rep is not None and _tiles(skv) * TILE > MAX_STAGED


def stream_smem_bytes(d: int, groups: int) -> int:
    """Shared memory of the streamed forward's block (its ``StreamTile``):
    two stages, each G K and V tiles of TILE keys (rows of D + 8 bf16), one
    (TILE x TILE + 8) bf16 bias tile and G fp32 key masks."""
    kv = groups * TILE * (d + 8) * 2
    return 2 * (2 * kv + TILE * (TILE + 8) * 2 + groups * TILE * 4)


def fwd_groups(n: int, sq: int, skv: int, h: int, rep: int | None) -> int:
    """G of the bf16 forward: 1 without a bias (``rep`` None); where the
    bias is streamed, the largest of ``STREAM_GROUP_CHOICES`` that divides
    ``rep``, leaves ``FWD_MIN_BLOCKS`` and fits its stages in ``MAX_SMEM``
    at the widest head dim; else ``groups_per_block``."""
    if rep is None:
        return 1
    blocks = _tiles(sq) * h * n
    if streamed(skv, rep):
        for g in STREAM_GROUP_CHOICES:
            if (rep % g == 0 and blocks // g >= FWD_MIN_BLOCKS
                    and stream_smem_bytes(max(HEAD_DIMS), g) <= MAX_SMEM):
                return g
        return 1
    return groups_per_block(rep, blocks, FWD_MIN_BLOCKS)


def bwd_groups(n: int, sq: int, skv: int, h: int, rep: int | None) -> int:
    """G of the bf16 backward's two sweeps: 1 without a bias, with rep = 1
    (each dS tile is then dbias itself), or where either sweep's bias slice
    (TILE x Skv in the dq sweep, Sq x TILE in the dk/dv sweep) is too wide
    to stage; the grid is that of the smaller sweep."""
    if (rep is None or rep == 1 or _tiles(skv) * TILE > MAX_STAGED
            or _tiles(sq) * TILE > MAX_STAGED):
        return 1
    return groups_per_block(rep, min(_tiles(sq), _tiles(skv)) * h * n,
                            BWD_MIN_BLOCKS)


def dbias_partials_shape(n: int, h: int, sq: int, skv: int, rep: int | None,
                         groups: int) -> tuple[int, ...] | None:
    """The bf16 backward's fp32 scratch for the bias gradient: one (H, Sq,
    Skv) partial per block chunk of G groups, (N / G, H, Sq, Skv), summed
    rep / G at a time in a fixed order. None without a bias or with rep = 1
    (the dq sweep then writes dbias itself)."""
    if rep is None or rep == 1:
        return None
    return (n // groups, h, sq, skv)


def copy_for_kernel(t: torch.Tensor) -> bool:
    """Whether a bf16 q/k/v/out/do view must be copied before the tensor-core
    kernels take it: they load rows with 16-byte copies, so the data pointer
    and the N and S strides must be multiples of 16 bytes (the dense (H, D)
    block always is: D is 16 or 32). The main path's layouts (column slices
    of a merged projection, contiguous tensors) never need it. A view that
    does is copied to a fresh contiguous tensor, never refused and never
    sent to the plain version."""
    return not (t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
                and t.stride(1) % 8 == 0)


def _check_groups(name: str, groups: int, rep: int, n: int,
                  choices: tuple[int, ...] | None) -> None:
    """G must divide rep and N, and be one of ``choices`` (None: any)."""
    if (groups < 1 or n % groups or rep % groups
            or (choices is not None and groups not in choices)):
        raise ValueError(f"{name}: G = {groups} must divide rep = {rep} and "
                         f"N = {n}, and be one of {choices or 'any'}: 1 "
                         "without a staged or streamed bias")


def _operand(fn: str, name: str, t: torch.Tensor, shape: tuple,
             dtype: torch.dtype, dev: int) -> tuple[torch.Tensor, int, int]:
    """Check one (N, S, H, D) operand: its shape, dtype and device and a
    dense (H, D) block. Returns it, copied where ``copy_for_kernel`` says
    so (bf16), with its N and S strides."""
    stride = t.stride()
    if t.shape != shape:
        raise ValueError(f"{fn}: {name} {tuple(t.shape)} is not (N, S, H, D) = "
                         f"{shape}")
    if stride[3] != 1 or stride[2] != shape[3]:
        raise ValueError(f"{fn}: {name} needs a dense (H, D) block, strides "
                         f"{stride}")
    if t.dtype != dtype or t.get_device() != dev:
        raise ValueError(f"{fn}: {name} {t.dtype} on {t.device} does not "
                         "match q")
    if dtype == torch.bfloat16 and copy_for_kernel(t):
        t = t.clone(memory_format=torch.contiguous_format)
        stride = t.stride()
    return t, stride[0], stride[1]


def _common(fn: str, q: torch.Tensor, k: torch.Tensor,
            bias: torch.Tensor | None, mask: torch.Tensor | None):
    """The checks both wrappers make: CUDA tensors of a kernel dtype, a head
    dim the kernels take, N and H within the grid; a contiguous (B, H, Sq,
    Skv) bias in q's dtype with N % B == 0; a contiguous (N, Skv) fp32
    mask. Returns (n, sq, skv, h, d, rep or None, device index)."""
    if not q.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, got {q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {q.dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"{fn}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "must be (N, S, H, D)")
    n, sq, h, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} not in {HEAD_DIMS}")
    if (n == 0 or sq == 0 or skv == 0 or n > _build.MAX_GRID_YZ
            or h > _build.MAX_GRID_YZ):
        raise ValueError(f"{fn}: N={n}, H={h}, Sq={sq}, Skv={skv} outside "
                         "the kernel's grid")
    dev = q.get_device()
    rep = None
    if bias is not None:
        nb = bias.shape[0]
        if (bias.ndim != 4 or bias.shape[1:] != (h, sq, skv) or n % nb != 0
                or bias.dtype != q.dtype or bias.get_device() != dev
                or not bias.is_contiguous()):
            raise ValueError(f"{fn}: bias {tuple(bias.shape)} {bias.dtype} "
                             f"must be contiguous (B, {h}, {sq}, {skv}) in "
                             f"{q.dtype} with N % B == 0")
        rep = n // nb
    if mask is not None and (mask.shape != (n, skv) or mask.dtype != torch.float32
                             or mask.get_device() != dev
                             or not mask.is_contiguous()):
        raise ValueError(f"{fn}: mask {tuple(mask.shape)} {mask.dtype} must be "
                         f"contiguous fp32 ({n}, {skv})")
    return n, sq, skv, h, d, rep, dev


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None, mask: torch.Tensor | None,
                         scale: float, groups: int | None = None,
                         kv_tile: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (N, Sq, H, D); k, v: (N, Skv, H, D), fp32 or bf16, all one dtype.
    bias: (B, H, Sq, Skv) contiguous in q's dtype with N % B == 0, or None.
    mask: (N, Skv) contiguous fp32 additive, or None. ``groups``: G of the
    bf16 kernel (default ``fwd_groups``). In bf16 a q/k/v view whose data
    pointer or N or S stride is not a multiple of 16 bytes is copied first
    (``copy_for_kernel``).
    ``kv_tile`` (AutoChunk's ``attn_kv_tile``) is accepted and ignored: the
    kernel's KV tile is ``TILE`` keys, fixed by its tensor-core fragments
    and shared-memory stages, and it allocates only out and lse, so no
    device buffer scales with a KV tile.
    Returns (out (N, Sq, H, D) in q's dtype, lse (N, H, Sq) fp32)."""
    fn = "flash_attention_cuda"
    n, sq, skv, h, d, rep, dev = _common(fn, q, k, bias, mask)
    stream = streamed(skv, rep)
    if groups is None:
        groups = fwd_groups(n, sq, skv, h, rep)
    _check_groups(fn, groups, rep or 1, n,
                  STREAM_GROUP_CHOICES if stream
                  else None if rep is not None else (1,))
    q, q_sn, q_ss = _operand(fn, "q", q, (n, sq, h, d), q.dtype, dev)
    k, k_sn, k_ss = _operand(fn, "k", k, (n, skv, h, d), q.dtype, dev)
    v, v_sn, v_ss = _operand(fn, "v", v, (n, skv, h, d), q.dtype, dev)
    out = torch.empty((n, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, sq), dtype=torch.float32, device=q.device)
    err = _build.entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        mask.data_ptr() if mask is not None else None,
        out.data_ptr(), lse.data_ptr(), q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
        n, sq, skv, h, d, rep or 1, groups, float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check("flash_attention_fwd", err,
                 "streamed_bias" if stream and q.dtype == torch.bfloat16
                 else None)
    return out, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, bias: torch.Tensor | None,
                             mask: torch.Tensor | None, scale: float,
                             need_dmask: bool = False,
                             groups: int | None = None):
    """The gradients of ``flash_attention_cuda``'s output from its saved
    (q, k, v, out, lse) and the cotangent ``do``.

    q, out, do: (N, Sq, H, D); k, v: (N, Skv, H, D); all one dtype (fp32 or
    bf16), each with a dense (H, D) block. lse: (N, H, Sq) contiguous fp32.
    bias, mask: as for the forward. ``groups``: G of the bf16 sweeps
    (default ``bwd_groups``); bf16 views are copied as in the forward.
    Returns (dq, dk, dv in q's dtype, dbias (B, H, Sq, Skv) in the bias's
    dtype or None, dmask (N, Skv) fp32 or None; dmask only when
    ``need_dmask`` and there is a mask). Deterministic: two calls on the
    same inputs give the same bits."""
    fn = "flash_attention_bwd_cuda"
    n, sq, skv, h, d, rep, dev = _common(fn, q, k, bias, mask)
    if (lse.shape != (n, h, sq) or lse.dtype != torch.float32
            or lse.get_device() != dev or not lse.is_contiguous()):
        raise ValueError(f"{fn}: lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"contiguous fp32 ({n}, {h}, {sq})")
    if groups is None:
        groups = bwd_groups(n, sq, skv, h, rep)
    _check_groups(fn, groups, rep or 1, n,
                  None if rep is not None and max(_tiles(sq), _tiles(skv))
                  * TILE <= MAX_STAGED else (1,))
    dt = q.dtype
    q, q_sn, q_ss = _operand(fn, "q", q, (n, sq, h, d), dt, dev)
    k, k_sn, k_ss = _operand(fn, "k", k, (n, skv, h, d), dt, dev)
    v, v_sn, v_ss = _operand(fn, "v", v, (n, skv, h, d), dt, dev)
    out, o_sn, o_ss = _operand(fn, "out", out, (n, sq, h, d), dt, dev)
    do, g_sn, g_ss = _operand(fn, "do", do, (n, sq, h, d), dt, dev)
    f32 = torch.float32
    dq = torch.empty((n, sq, h, d), dtype=dt, device=q.device)
    dk = torch.empty((n, skv, h, d), dtype=dt, device=q.device)
    dv = torch.empty((n, skv, h, d), dtype=dt, device=q.device)
    dbias = torch.empty_like(bias) if bias is not None else None
    dmask = None
    if need_dmask and mask is not None:
        dmask = torch.empty((n, skv), dtype=f32, device=q.device)
    # One fp32 scratch: delta (N, H, Sq), then the per-head dmask (N, H,
    # Skv) and the bias-gradient partials where they are wanted, each at a
    # 16-byte boundary.
    part_shape = dbias_partials_shape(n, h, sq, skv, rep, groups)
    sizes = [n * h * sq, n * h * skv if dmask is not None else 0,
             (part_shape[0] * h * sq * skv
              if part_shape is not None and dt == torch.bfloat16 else 0)]
    offsets = [0]
    for size in sizes[:-1]:
        offsets.append(offsets[-1] + -(-size // 4) * 4)
    scratch = torch.empty(offsets[-1] + sizes[-1], dtype=f32, device=q.device)
    base = scratch.data_ptr()
    delta_p, dmask_h_p, part_p = (base + 4 * off if size else None
                                  for off, size in zip(offsets, sizes))
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = _build.entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), ptr(bias), ptr(mask), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ptr(dbias), part_p, ptr(dmask), delta_p, dmask_h_p,
        q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, g_sn, g_ss,
        n, sq, skv, h, d, rep or 1, groups, float(scale),
        _build.DTYPE_CODES[dt], _build.stream_handle(q))
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv, dbias, dmask
