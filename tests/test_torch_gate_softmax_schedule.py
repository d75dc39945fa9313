"""What surrounds the gating kernel (K2) and the fused softmax kernel (K4),
on the CPU: the kernels themselves run only on the card
(tests/test_torch_cuda.py).

1. K2's index map, as ``csrc/bias_sigmoid_mul.cu`` forms it from
   ``gate_partition``: the rows of the grid's threads, the 16-byte vectors
   (or single elements) each thread of a row takes two at a time, the bias
   channel each reads; every element covered once, every vector load
   aligned.
2. K4's index map, as ``csrc/fused_softmax.cu`` forms it from
   ``softmax_partition`` and ``softmax_steps``: each warp's run of rows, the
   rows each lane group takes, the n, bias row and mask row it keeps by
   increments (the mask row loaded once per n), the elements each lane
   holds; and the block-per-row kernel's elements above 1024.
3. Numpy models of the two kernels' arithmetic: K2's sigmoid as
   rcp.approx(1 + ex2.approx(-z log2 e)) in bf16 and 1 / (1 + expf(-z)) in
   fp32, K4's logits in the reference's order, ex2.approx of (l - m) log2 e
   and one reciprocal a row, each approximation pushed to its worst stated
   error (ex2.approx and expf 2 ulp, rcp.approx 1 ulp) both ways, held
   against the port's plain versions
   and the reference's interpret-mode Pallas kernels within the tolerances
   the card holds the kernels to: K2 fp32 1e-5 and bf16 1e-2 of
   max(1, max|plain|); K4 per element max(tol * |plain|, 1e-9), tol 1e-5
   fp32 and 2**-7 bf16 (one bf16 rounding of the output), NaN exactly
   where the plain version has it.
The models live here; nothing on the main path uses them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_elementwise import bias_sigmoid_mul_pallas
from repro.kernels.fused_softmax import fused_softmax_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.fused_elementwise import gate_partition
from repro_torch.kernels.fused_softmax import (MAX_VECTORS_PER_LANE,
                                               MAX_WARP_C, MIN_WARPS,
                                               ROWS_IN_FLIGHT, SCALAR_NVL,
                                               WARP, softmax_partition,
                                               softmax_steps)
from torch_parity import DTYPES, normal

GATE_THREADS = 128      # kThreads of bias_sigmoid_mul.cu
SOFTMAX_WARPS = 8       # kWarps of fused_softmax.cu
ROW_BLOCK = 512         # kRowBlock: the block-per-row kernel's threads
LOG2E = np.float32(1.4426950408889634)
EX2_ULP = 2.0 ** -22    # ex2.approx.ftz.f32 and expf: at most 2 ulp
RCP_ULP = 2.0 ** -23    # rcp.approx.ftz.f32: at most 1 ulp
GATE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SOFTMAX_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
SOFTMAX_ATOL = 1e-9
ITEMSIZE = {"float32": 4, "bfloat16": 2}


# ---------------------------------------------------------------------------
# 1. K2's index map
# ---------------------------------------------------------------------------


def gate_thread_rows(rows: int, lanes: int):
    """(row, thread of the row) of every thread of the grid whose row
    exists, as the kernel forms them: block b, thread t -> row b * (128 /
    lanes) + t / lanes, thread t % lanes."""
    per_block = GATE_THREADS // lanes
    blocks = -(-rows // per_block)
    t = np.arange(GATE_THREADS)
    row = (np.arange(blocks)[:, None] * per_block + t // lanes).ravel()
    sub = np.broadcast_to(t % lanes, (blocks, GATE_THREADS)).ravel()
    live = row < rows
    return row[live], sub[live]


def gate_thread_elements(c: int, vec: int, lanes: int, sub: int):
    """The (offset in the row, bias channel) of every element thread
    ``sub`` of a row writes, in its loop's order: vectors k and k + lanes,
    k = sub, sub + 2 lanes, ..., the second only where it is in the row."""
    nv = c // vec
    out = []
    for k in range(sub, nv, 2 * lanes):
        for kk in (k, k + lanes):
            if kk < nv:
                out += [(kk * vec + i, kk * vec + i) for i in range(vec)]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", [1, 8, 12, 16, 24, 32, 72, 128, 200, 256, 384,
                               1000])
def test_gate_threads_cover_each_element_once(c, aligned, dtype):
    """Every channel of a row is written once, reading its own bias
    channel; a vector starts 16 bytes into the row at a multiple of 16, so
    with C a whole number of vectors every load of an aligned tensor is
    aligned."""
    itemsize = ITEMSIZE[dtype]
    vec, lanes = gate_partition(c, itemsize, aligned)
    per_vec = 16 // itemsize
    assert vec == (per_vec if aligned and c % per_vec == 0 else 1)
    assert lanes in (1, 2, 4, 8, 16, 32)
    # The least power of two of threads that holds the row's vectors.
    assert lanes == WARP or lanes >= c // vec > lanes // 2
    cover = np.zeros(c, int)
    for sub in range(lanes):
        for off, ch in gate_thread_elements(c, vec, lanes, sub):
            assert ch == off
            cover[off] += 1
    assert (cover == 1).all()
    if vec > 1:
        # Row r's vector k starts (r C + k vec) * itemsize bytes in: a
        # multiple of 16 when C is whole vectors of 16 bytes.
        assert (c * itemsize) % 16 == 0 and vec * itemsize == 16


@pytest.mark.parametrize("shape,dtype,part", [
    ((1, 128, 256, 256), "bfloat16", (8, 32)),     # MSA-row gate
    ((1, 256, 256, 128), "bfloat16", (8, 16)),     # pair gate, two rows a warp
    ((1, 384, 384, 128), "bfloat16", (8, 16)),     # pair gate r = 384
    ((1, 128, 256, 256), "float32", (4, 32)),      # two vectors a thread
    ((1, 16, 12, 32), "bfloat16", (8, 4)),         # SMOKE's MSA gate
    ((1, 12, 12, 16), "bfloat16", (8, 2)),         # SMOKE's pair gate
    ((9, 24), "float32", (4, 8)),
])
def test_gate_grid_covers_every_row_once(shape, dtype, part):
    """At the main path's and the SMOKE widths: the grid's threads give
    each row exactly ``lanes`` threads, so with the per-row cover above
    every element of the tensor is written once."""
    c = shape[-1]
    rows = int(np.prod(shape)) // c
    vec, lanes = gate_partition(c, ITEMSIZE[dtype], True)
    assert (vec, lanes) == part
    row, sub = gate_thread_rows(rows, lanes)
    assert (np.bincount(row, minlength=rows) == lanes).all()
    assert np.unique(row * lanes + sub).size == rows * lanes
    # One vector a thread at the bf16 main-path widths: the grid has one
    # thread per vector.
    if dtype == "bfloat16":
        assert rows * lanes * vec == rows * c


# ---------------------------------------------------------------------------
# 2. K4's index map
# ---------------------------------------------------------------------------


def softmax_walk(rows: int, hr: int, rep: int, lanes: int, steps: int):
    """Every row the rows kernel computes, as its lane groups walk them:
    returns (row, n, bias row, mask row held, mask loads) over all lane
    groups, the loads summed per lane group. The bookkeeping is the
    kernel's: n, the place ``in`` within n's H*R rows and the bias batch
    formed once by division, then advanced by the groups a warp holds,
    divided again only where ``in`` passes H*R; the mask row reloaded
    where a row's n differs from the one held."""
    groups = WARP // lanes
    warp_rows = steps * ROWS_IN_FLIGHT * groups
    warps = -(-rows // warp_rows)
    blocks = -(-warps // SOFTMAX_WARPS)
    w0 = np.arange(blocks * SOFTMAX_WARPS) * warp_rows
    w0 = w0[w0 < rows]
    row = w0[:, None] + np.arange(groups)[None, :]
    n = row // hr
    inn = row - n * hr
    nb = n // rep
    held = np.full(row.shape, -1)
    loads = np.zeros(row.shape, int)
    out = []
    for s in range(steps):
        live = (w0 + s * ROWS_IN_FLIGHT * groups < rows)[:, None]
        slots = []
        for _ in range(ROWS_IN_FLIGHT):
            slots.append((row.copy(), n.copy(), nb * hr + inn))
            row = row + groups
            inn = inn + groups
            wrap = inn >= hr
            n = np.where(wrap, n + inn // hr, n)
            inn = np.where(wrap, inn % hr, inn)
            nb = np.where(wrap, n // rep, nb)
        for rrow, rn, brow in slots:
            ok = live & (rrow < rows)
            reload = ok & (rn != held)
            loads += reload
            held = np.where(reload, rn, held)
            out.append((rrow[ok], rn[ok], brow[ok], held[ok]))
    cat = [np.concatenate([o[i] for o in out]) for i in range(4)]
    return (*cat, loads)


def softmax_lane_elements(c: int, part):
    """The elements lane ``sub`` of a row holds, for each sub: vectors
    sub + k lanes (k < NVL) that lie in the row, VEC elements each; for the
    block kernel, thread t's elements i * 512 + t."""
    if part is None:
        items = next(n for n in (4, 8, 16, 32) if n * ROW_BLOCK >= c)
        return [[i * ROW_BLOCK + t for i in range(items) if i * ROW_BLOCK + t < c]
                for t in range(ROW_BLOCK)]
    lanes, nvl, vec = part
    nv = c // vec
    return [[(sub + k * lanes) * vec + i for k in range(nvl)
             if sub + k * lanes < nv for i in range(vec)]
            for sub in range(lanes)]


EDGE_C = [1, 33, 128, 200, 256, 384, 1024, 1025, 16384]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", EDGE_C)
def test_softmax_lanes_cover_each_element_once(c, aligned, dtype):
    itemsize = ITEMSIZE[dtype]
    part = softmax_partition(c, itemsize, aligned)
    assert (part is None) == (c > MAX_WARP_C)
    elems = softmax_lane_elements(c, part)
    cover = np.bincount([e for lane in elems for e in lane], minlength=c)
    assert cover.size == c and (cover == 1).all()
    if part is None:
        return
    lanes, nvl, vec = part
    per_vec = 16 // itemsize
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes * nvl * vec >= c
    if vec > 1:
        # Vectors only where C is whole vectors and the pointers aligned:
        # then every row of x, the bias, the output (C * itemsize bytes)
        # and the mask (4 C bytes) starts on 16 bytes, and so every vector.
        assert aligned and vec == per_vec and c % vec == 0
        assert 1 <= nvl <= MAX_VECTORS_PER_LANE
        assert (c * itemsize) % 16 == 0 and (4 * c) % 16 == 0
    else:
        assert nvl in SCALAR_NVL and nvl * vec <= 32
    # No lane idles where C is a whole number of vectors that the largest
    # power of two of lanes dividing them spreads within the register cap.
    if vec > 1 and (c // vec) % lanes == 0:
        assert all(len(lane) == nvl * vec for lane in elems)


def test_softmax_partition_main_path():
    """bf16 at the main path's widths: C = 256 (MSA row, triangle) a warp a
    row, one vector a lane; C = 128 (MSA column) 16 lanes, two rows a warp;
    C = 384 (triangle at r = 384) 16 lanes of three vectors, every lane
    used. Misaligned, one element at a time."""
    assert softmax_partition(256, 2, True) == (32, 1, 8)
    assert softmax_partition(128, 2, True) == (16, 1, 8)
    assert softmax_partition(384, 2, True) == (16, 3, 8)
    assert softmax_partition(200, 2, True) == (32, 1, 8)     # 25 vectors
    assert softmax_partition(256, 2, False) == (32, 8, 1)
    assert softmax_partition(33, 4, True) == (32, 2, 1)
    assert softmax_partition(1, 2, True) == (1, 1, 1)
    assert softmax_partition(1025, 2, True) is None
    # Runs: 16 rows a warp at MSA row, MSA column and triangle (262144
    # rows), 32 at triangle r = 384 (589824 rows), 16384 warps or more.
    for rows, lanes, steps in [(262144, 32, 8), (262144, 16, 4),
                               (589824, 16, 8), (1000, 32, 1)]:
        assert softmax_steps(rows, lanes) == steps
        run = steps * ROWS_IN_FLIGHT * (WARP // lanes)
        assert steps == 1 or -(-rows // run) >= MIN_WARPS


# (N, H, R, C, B): the main path's four calls, then the edges: rep 1, N*H*R
# not a multiple of a run, H*R not a multiple of a run (runs cross an n),
# H*R = 1 (every row its own n), C past the rows kernel.
WALK_CASES = [
    (128, 8, 256, 256, 1),      # MSA row: rep 128
    (256, 8, 128, 128, 0),      # MSA column: no bias
    (256, 4, 256, 256, 1),      # triangle: rep 256
    (384, 4, 384, 384, 1),      # triangle r = 384
    (7, 3, 5, 128, 7),          # rep 1; H*R = 15: runs cross an n
    (5, 2, 9, 33, 1),           # scalar lanes, ragged
    (6, 1, 1, 200, 2),          # H*R = 1
    (3, 2, 7, 1, 3),            # C = 1: a lane a row
    (9, 5, 3, 256, 3),          # 135 rows: the last run short
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,r,c,nb", WALK_CASES)
def test_softmax_runs_cover_each_row_once(n, h, r, c, nb, dtype):
    """Each row once, reading mask row n = row // (H R) and bias row
    (n // rep, h, r) as ``ref.softmax_ref`` does; the mask row loaded once
    per n a lane group meets."""
    rows, hr = n * h * r, h * r
    rep = n // nb if nb else 1
    part = softmax_partition(c, ITEMSIZE[dtype], True)
    lanes = part[0]
    steps = softmax_steps(rows, lanes)
    row, rn, brow, held, loads = softmax_walk(rows, hr, rep, lanes, steps)
    assert (np.bincount(row, minlength=rows) == 1).all() and row.size == rows
    assert (rn == row // hr).all() and (held == rn).all()
    hh, rr = (row % hr) // r, row % r
    assert (brow == ((rn // rep) * h + hh) * r + rr).all()
    # One mask load for each n that a lane group's rows touch: its rows
    # w0 + g + j * groups are in order, so each n is one stretch of j.
    groups = WARP // lanes
    run = steps * ROWS_IN_FLIGHT * groups
    mine = (np.arange(0, rows, run)[:, None, None]
            + np.arange(groups)[None, :, None]
            + np.arange(run // groups)[None, None, :] * groups)
    live = mine < rows
    mn = mine // hr
    distinct = (live[..., 0].sum()
                + (live[..., 1:] & (mn[..., 1:] != mn[..., :-1])).sum())
    assert loads.sum() == distinct
    if hr % run == 0:
        assert loads.sum() == rows // run * groups


# ---------------------------------------------------------------------------
# 3. The arithmetic
# ---------------------------------------------------------------------------


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def ex2_approx(a, sign):
    """2**a rounded to fp32, moved by ex2.approx's worst error (2 ulp) in
    the direction ``sign``; results below fp32's normal range flushed to
    zero (.ftz)."""
    with np.errstate(over="ignore"):
        e = _f32(np.exp2(a.astype(np.float64)))
    e = _f32(e * np.float32(1 + sign * EX2_ULP))
    return np.where(e < np.finfo(np.float32).tiny, np.float32(0), e)


def gate_model(g, bg, v, sign):
    """K2's arithmetic: z = g + bg; in bf16 s = rcp(1 + ex2(-z log2 e)), in
    fp32 s = 1 / (1 + expf(-z)) (an IEEE division); s * v in fp32, one cast
    to v's dtype."""
    z = _f32(g.float().numpy() + bg.float().numpy())
    fast = v.dtype == torch.bfloat16
    # ex2.approx takes -z log2 e rounded to fp32, expf takes -z as it is.
    a = _f32(z * -LOG2E) if fast else -z.astype(np.float64) * np.log2(np.e)
    e = ex2_approx(a, sign)
    with np.errstate(divide="ignore", over="ignore"):
        s = _f32(1.0 / _f32(np.float32(1) + e).astype(np.float64))
    if fast:
        s = _f32(s * np.float32(1 + sign * RCP_ULP))
    y = _f32(s * v.float().numpy())
    return torch.from_numpy(y).to(v.dtype)


def softmax_model(x, bias, mask, scale, sign):
    """K4's arithmetic: the logits x*scale, + bias, + mask in fp32, each
    rounded; the max (non-finite taken as 0); ex2 of (l - m) rounded, times
    log2 e rounded; the sum; one reciprocal of it a row (IEEE: fp64 then
    rounded); each element times it; one cast."""
    n, h, r, c = x.shape
    lg = _f32(x.float().numpy() * np.float32(scale))
    if bias is not None:
        b = bias.float().numpy()
        lg = _f32(lg.reshape((b.shape[0], -1, h, r, c)) + b[:, None]).reshape(
            lg.shape)
    if mask is not None:
        lg = _f32(lg + mask.numpy()[:, None, None, :])
    m = lg.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, np.float32(0))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        e = ex2_approx(_f32(_f32(lg - m) * LOG2E), sign)
        s = e.sum(-1, keepdims=True, dtype=np.float32)
        inv = _f32(1.0 / s.astype(np.float64))
        y = _f32(e * inv)
    return torch.from_numpy(y).to(x.dtype)


def softmax_err(got, want, tol):
    """max |got - want| / max(|want|, SOFTMAX_ATOL / tol) off the NaNs."""
    nan = torch.isnan(want)
    g = got.float().masked_fill(nan, 0)
    w = want.float().masked_fill(nan, 0)
    return ((g - w).abs() / w.abs().clamp_min(SOFTMAX_ATOL / tol)).max().item()


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(9, 24), (2, 3, 5, 128), (3, 4, 12)])
def test_gate_model_within_tolerance(shape, dtype, sign):
    """The sigmoid (bf16: ex2.approx and rcp.approx; fp32: expf and a
    division), at its worst, against
    ``ref.bias_sigmoid_mul_ref`` and the reference's interpret-mode
    ``bias_sigmoid_mul_pallas``; z spans the sigmoid's range and beyond,
    where 2**x overflows and the sigmoid is 0."""
    rng = np.random.default_rng(7)
    c = shape[-1]
    g_np = normal(rng, shape, 8.0)
    g_np.reshape(-1)[:6] = [-100.0, -88.8, -87.0, 0.0, 40.0, 100.0]
    v_np, bg_np = normal(rng, shape, 2.0), normal(rng, (c,))
    tdt = DTYPES[dtype][1]
    g, v, bg = (torch.from_numpy(g_np).to(tdt), torch.from_numpy(v_np).to(tdt),
                torch.from_numpy(bg_np))
    got = gate_model(g, bg, v, sign)
    plain = ref.bias_sigmoid_mul_ref(g, bg, v)
    tol = GATE_TOL[dtype]
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= tol * max(1.0, plain.float().abs().max().item())
    jdt = DTYPES[dtype][0]
    want = bias_sigmoid_mul_pallas(jnp.asarray(g_np).astype(jdt),
                                   jnp.asarray(bg_np),
                                   jnp.asarray(v_np).astype(jdt),
                                   interpret=True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    err = (got.float() - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item())
    # In fp32 the approximations cost a few 1e-7 at most.
    if dtype == "float32":
        assert (got - plain).abs().max().item() <= 1e-6 * max(
            1.0, plain.abs().max().item())


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,r,c,nb", [
    (6, 2, 5, 256, 2), (4, 2, 3, 200, 4), (3, 1, 4, 33, 1), (2, 2, 3, 1, 1),
    (6, 2, 5, 128, 3), (4, 2, 3, 384, 1), (2, 1, 2, 1025, 1)])
def test_softmax_model_within_tolerance(n, h, r, c, nb, dtype, sign):
    """ex2.approx and one reciprocal a row, at their worst, against
    ``ref.softmax_ref`` and the reference's interpret-mode
    ``fused_softmax_pallas``, element by element: mask row 0 all -1e9
    (near-uniform, as in the plain version), mask row N-1 all -inf (NaN
    exactly where the plain version has it: 0 * (1/0))."""
    rng = np.random.default_rng(11)
    x_np = normal(rng, (n, h, r, c), 4.0)
    b_np = normal(rng, (nb, h, r, c))
    m_np = np.where(rng.random((n, c)) < 0.8, 0.0, -1e9).astype(np.float32)
    m_np[0] = -1e9
    m_np[-1] = -np.inf
    tdt = DTYPES[dtype][1]
    x, b = torch.from_numpy(x_np).to(tdt), torch.from_numpy(b_np).to(tdt)
    m = torch.from_numpy(m_np)
    scale = 32 ** -0.5
    got = softmax_model(x, b, m, scale, sign)
    plain = ref.softmax_ref(x, b, m, scale)
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(got), nan)
    assert nan[-1].all() and not nan[:-1].any()
    tol = SOFTMAX_TOL[dtype]
    assert softmax_err(got, plain, tol) <= tol
    # The -1e9 row: every element of it the same value, 1/C rounded.
    row0 = got[0].float()
    assert torch.equal(row0, row0[..., :1].expand_as(row0))
    jdt = DTYPES[dtype][0]
    want = fused_softmax_pallas(jnp.asarray(x_np).astype(jdt),
                                jnp.asarray(b_np).astype(jdt),
                                jnp.asarray(m_np), scale=scale, has_bias=True,
                                has_mask=True, interpret=True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    # Against the reference, the bf16 limit allows one more rounding: the
    # two frameworks each round the same fp32 value once.
    assert softmax_err(got, want, tol) <= (tol if dtype == "float32"
                                           else 2 * tol)


def test_softmax_model_without_bias_or_mask():
    """No bias and no mask: the logits are x*scale alone (the kernel adds
    +0.0, which leaves them as they are)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(normal(rng, (3, 2, 4, 96), 4.0))
    got = softmax_model(x, None, None, 0.5, 1)
    assert softmax_err(got, ref.softmax_ref(x, None, None, 0.5), 1e-5) <= 1e-5
