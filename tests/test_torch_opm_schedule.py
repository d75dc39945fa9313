"""What surrounds the outer-product-mean kernel (K8) and the LayerNorm
kernel's vector path (K1), on the CPU: the kernels themselves run only on
the card (tests/test_torch_cuda.py).

1. K8's layout, as ``csrc/outer_product_mean.cu`` lays it out: the
   persistent walk over 8 x 8-pixel tiles (``tile_walk``), the shared ov
   buffer of a tile (``ov_offset``: 64 pixels x C^2 in blocks of 8 c1 x 8
   c2 columns, 128-byte swizzled), the rows of w each chunk gathers
   (``w_chunk_q``) and where each consumer thread's stmatrix fragments land.
2. A plain-torch emulation of K8's schedule: per tile, NSUB sub-tiles of
   128 / C rows i, each an fp32 GEMM over s in stages of 32 rows (zero
   fill past S, I and J), the norm summed from the staged masks by the
   kernel's thread partition, one fp32 reciprocal per pixel, ov scaled,
   cast and written through the swizzle; then ov @ w chunk by chunk in the
   block's staggered order, bias, one cast. It is held against the
   reference's interpret-mode Pallas kernel ``fused_opm_pallas`` and the
   port's plain version ``ref.outer_product_mean_ref``.
3. K1's vector path: ``ln_partition`` (how a row is split over lanes and
   16-byte vectors) and an emulation of the kernel's per-lane sums and
   shuffle trees, against ``ref.layer_norm_ref`` and the reference's
   interpret-mode ``layer_norm_pallas``.
The emulations live here; nothing on the main path uses them.

Tolerances: max|emulation - reference| <= tol * max(1, max|reference|),
tol 1e-4 in fp32 (the same sums in another order; the reciprocal
multiplied where the references divide) and 2e-2 in bf16 (ov and the
output rounded once to bf16: a value on the other side of a rounding
boundary moves the result by a bf16 ulp of an operand).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layer_norm as jln
from repro.kernels import triangle as jtri
from repro_torch.kernels import ref
from repro_torch.kernels.layer_norm import MAX_VECTORS_PER_LANE, ln_partition
from torch_parity import DTYPES, MODULE_TOL, assert_close, normal

TILE = 8            # a tile's side in pixels (kTI = kTJ)
ST = 32             # s rows a stage (kST)
ROW_B = 128         # bytes of a swizzled shared-memory row
BLOCK_B = 64 * ROW_B
CONSUMERS = 256     # threads of the two consumer warpgroups
NORM_EPS = 1e-3


def geometry(c: int) -> dict:
    """``OpmGeo<C, D>``'s tile shape: i of a sub-tile (M = 128), sub-tiles a
    tile, pixels a sub-tile, N of the outer product, channel groups of 8
    and ov blocks (= w chunks)."""
    tis = 128 // c
    return {"tis": tis, "nsub": TILE // tis, "nps": tis * TILE,
            "nop": TILE * c, "g8": c // 8, "nkb": (c // 8) ** 2}


def tile_walk(bsz: int, ni: int, nj: int, n_sm: int) -> list[list[tuple]]:
    """Each persistent block's tiles (b, i0, j0), in order: the grid is
    min(tiles, n_sm) blocks, block k takes tiles k, k + grid, ..., a
    tile's index running over j fastest, then i, then b."""
    ntj, nti = -(-nj // TILE), -(-ni // TILE)
    n = bsz * nti * ntj
    grid = min(n, n_sm)
    walks = []
    for blk in range(grid):
        walk = []
        for t in range(blk, n, grid):
            tj, rest = t % ntj, t // ntj
            walk.append((rest // nti, (rest % nti) * TILE, tj * TILE))
        walks.append(walk)
    return walks


def ov_offset(p: int, c1: int, c2: int, c: int) -> int:
    """Byte offset of ov[pixel p, (c1, c2)] in a tile's shared ov buffer:
    block kb = (c1 // 8) * (C / 8) + c2 // 8 holds 64 pixel rows of 128
    bytes, column (c1 % 8) * 8 + c2 % 8; its 16-byte chunk is XORed with
    p % 8, the 128-byte swizzle wgmma reads a K-major operand with."""
    kb = (c1 // 8) * (c // 8) + c2 // 8
    col = (c1 % 8) * 8 + c2 % 8
    return kb * BLOCK_B + p * ROW_B + (((col // 8) ^ (p % 8)) << 4) + (col % 8) * 2


def w_chunk_q(kb: int, c: int) -> torch.Tensor:
    """The rows q = c1 C + c2 of w that chunk kb gathers (a 4-d TMA box of
    8 c1 x 8 c2), in their shared-memory row order."""
    g8 = c // 8
    c1 = 8 * (kb // g8) + torch.arange(8).repeat_interleave(8)
    c2 = 8 * (kb % g8) + torch.arange(8).repeat(8)
    return c1 * c + c2


def ov_index(c: int) -> torch.Tensor:
    """(64, C, C) element (2-byte) offsets of ov[p, c1, c2]."""
    idx = torch.empty((TILE * TILE, c, c), dtype=torch.long)
    for p in range(TILE * TILE):
        for c1 in range(c):
            for c2 in range(c):
                idx[p, c1, c2] = ov_offset(p, c1, c2, c) // 2
    return idx


# ---------------------------------------------------------------------------
# 1. Layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bsz,ni,nj,n_sm", [
    (1, 256, 256, 132), (1, 384, 384, 132), (2, 21, 19, 132),
    (3, 9, 30, 4), (1, 5, 3, 132), (2, 64, 72, 1)])
def test_tile_walk_covers_every_pixel_once(bsz, ni, nj, n_sm):
    seen = torch.zeros((bsz, ni, nj), dtype=torch.long)
    walks = tile_walk(bsz, ni, nj, n_sm)
    assert len(walks) == min(n_sm, bsz * -(-ni // TILE) * -(-nj // TILE))
    for walk in walks:
        for b, i0, j0 in walk:
            seen[b, i0:i0 + TILE, j0:j0 + TILE] += 1
    assert bool((seen == 1).all())
    # The blocks' loads differ by at most one tile.
    sizes = {len(w) for w in walks}
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("c", [16, 32])
def test_ov_layout_is_a_bijection(c):
    idx = ov_index(c)
    assert sorted(idx.reshape(-1).tolist()) == list(range(TILE * TILE * c * c))
    g = geometry(c)
    assert g["nkb"] * BLOCK_B == TILE * TILE * c * c * 2
    # One row (p, c1) of a fragment, 8 consecutive c2, is 16 contiguous
    # bytes on a 16-byte boundary: one stmatrix row.
    for p in (0, 13, 63):
        for c1 in range(c):
            for c2g in range(c // 8):
                offs = idx[p, c1, 8 * c2g:8 * c2g + 8]
                assert offs[0] % 8 == 0
                assert offs.tolist() == list(range(int(offs[0]), int(offs[0]) + 8))


@pytest.mark.parametrize("c", [16, 32])
def test_fragment_rows_are_one_swizzled_row(c):
    """The 8 rows (c1 % 8) of one 8 x 8 fragment lie in 8 different 16-byte
    chunks of one 128-byte row: stmatrix stores them without a bank
    conflict, and the chunk is the swizzled one wgmma reads."""
    g8 = c // 8
    for p in range(TILE * TILE):
        for c1g in range(g8):
            for c2g in range(g8):
                offs = [ov_offset(p, 8 * c1g + r, 8 * c2g, c) for r in range(8)]
                rows = {o // ROW_B for o in offs}
                assert len(rows) == 1
                chunks = [(o % ROW_B) // 16 for o in offs]
                assert sorted(chunks) == list(range(8))
                assert chunks == [r ^ (p % 8) for r in range(8)]


@pytest.mark.parametrize("c", [16, 32])
def test_consumer_fragments_and_stmatrix_addresses(c):
    """Each consumer thread's accumulator element and the address its lane
    gives stmatrix, as the kernel computes them, land on ov_offset."""
    g = geometry(c)
    g8 = g["g8"]
    for sub in range(g["nsub"]):
        for wg in range(2):
            for wq in range(4):
                il_sub = (64 * wg + 16 * wq) // c
                c1g0 = ((16 * wq) % c) // 8
                ilt = sub * g["tis"] + il_sub
                for lane in range(32):
                    gr, tq = lane // 4, lane % 4
                    for nt in range(g["nop"] // 8):
                        for h in range(2):
                            # The accumulator element (rows m, columns n).
                            m = 64 * wg + 16 * wq + gr + 8 * h
                            n = 8 * nt + 2 * tq
                            i, c1 = divmod(m, c)
                            j, c2 = divmod(n, c)
                            assert (i, c1 // 8, c1 % 8) == (il_sub, c1g0 + h, gr)
                            assert (j, c2) == (nt // g8, 8 * (nt % g8) + 2 * tq)
                            # The row address lane (8 e + row) gives matrix
                            # (nt, h) = e of its stmatrix.
                            row = lane % 8
                            jl = nt // g8
                            kb = (c1g0 + h) * g8 + nt % g8
                            pix = ilt * TILE + jl
                            addr = kb * BLOCK_B + pix * ROW_B + ((row ^ jl) << 4)
                            assert addr == ov_offset(pix, 8 * (c1g0 + h) + row,
                                                     8 * (nt % g8), c)


@pytest.mark.parametrize("c", [16, 32])
def test_w_chunks_gather_ov_columns(c):
    """Chunk kb holds every row of w once, in ov block kb's column order."""
    g = geometry(c)
    qs = torch.cat([w_chunk_q(kb, c) for kb in range(g["nkb"])])
    assert sorted(qs.tolist()) == list(range(c * c))
    for kb in range(g["nkb"]):
        q = w_chunk_q(kb, c)
        for col in range(64):
            c1 = 8 * (kb // g["g8"]) + col // 8
            c2 = 8 * (kb % g["g8"]) + col % 8
            assert int(q[col]) == c1 * c + c2
            assert ov_offset(5, c1, c2, c) // BLOCK_B == kb


# ---------------------------------------------------------------------------
# 2. Emulation of K8's schedule
# ---------------------------------------------------------------------------


def emulate_opm(a, b_full, mask_a, mask_b, w, bias, n_sm=132):
    """(B, I, J, D) by K8's schedule, in a's dtype."""
    dt = a.dtype
    bsz, ns, ni, c = a.shape
    nj, d = b_full.shape[2], w.shape[1]
    g = geometry(c)
    tis, nps = g["tis"], g["nps"]
    u = CONSUMERS // nps
    # Zero fill past S, I and J, as TMA's out-of-bounds fill and the
    # producer's mask loads give it.
    sp = -(-ns // ST) * ST
    ip, jp = -(-ni // TILE) * TILE, -(-nj // TILE) * TILE
    ap = torch.zeros((bsz, sp, ip, c), dtype=dt)
    bp = torch.zeros((bsz, sp, jp, c), dtype=dt)
    map_ = torch.zeros((bsz, sp, ip))
    mbp = torch.zeros((bsz, sp, jp))
    ap[:, :ns, :ni], bp[:, :ns, :nj] = a, b_full
    map_[:, :ns, :ni], mbp[:, :ns, :nj] = mask_a, mask_b
    idx = ov_index(c)
    # The norm's threads: pixel t // u of the sub-tile, s rows t % u + u k.
    t = torch.arange(CONSUMERS)
    npix, nu = t // u, t % u
    out = torch.empty((bsz, ni, nj, d), dtype=dt)
    for blk, walk in enumerate(tile_walk(bsz, ni, nj, n_sm)):
        for bb, i0, j0 in walk:
            ov = torch.zeros(TILE * TILE * c * c, dtype=dt)
            for sub in range(g["nsub"]):
                is0 = i0 + sub * tis
                acc = torch.zeros((128, g["nop"]))
                part = torch.zeros(CONSUMERS)
                for s0 in range(0, sp, ST):
                    am = ap[bb, s0:s0 + ST, is0:is0 + tis].reshape(ST, 128)
                    bm = bp[bb, s0:s0 + ST, j0:j0 + TILE].reshape(ST, g["nop"])
                    acc += am.float().t() @ bm.float()
                    ma = map_[bb, s0:s0 + ST, is0:is0 + tis]
                    mb = mbp[bb, s0:s0 + ST, j0:j0 + TILE]
                    prod = ma[:, npix // TILE] * mb[:, npix % TILE]   # (ST, 256)
                    part += (prod * (torch.arange(ST)[:, None] % u == nu)).sum(0)
                norm = part.view(nps, u).sum(1)
                inv = torch.reciprocal(norm + NORM_EPS)            # fp32
                o = acc.view(tis, c, TILE, c).permute(0, 2, 1, 3)  # (il, jl, c1, c2)
                v = (o * inv.view(tis, TILE, 1, 1)).to(dt)
                pix = sub * nps + torch.arange(nps)
                ov[idx[pix]] = v.reshape(nps, c, c)
            z = torch.zeros((TILE * TILE, d))
            for k in range(g["nkb"]):
                kb = (k + blk) % g["nkb"]                          # staggered
                q = w_chunk_q(kb, c)
                cols = idx[:, q // c, q % c]                       # (64, 64)
                z += ov[cols].float() @ w[q].to(dt).float()
            z = (z + bias.float()).to(dt).view(TILE, TILE, d)
            ie, je = min(i0 + TILE, ni), min(j0 + TILE, nj)
            out[bb, i0:ie, j0:je] = z[:ie - i0, :je - j0]
    return out


# (B, S, I, J, C, D, fully masked MSA rows, fully masked residues): S off
# the 32-row stage, I and J off the 8-pixel tile, B = 2, the MINI widths.
OPM_CASES = {
    "full-width-c32": (1, 37, 11, 13, 32, 128, (2,), (4,)),
    "b2-c16-d32": (2, 40, 9, 17, 16, 32, (0,), (8,)),
    "c16-d128-s-below-a-stage": (1, 7, 16, 10, 16, 128, (), (0,)),
}


def _opm_inputs(case, dtype):
    bsz, ns, ni, nj, c, d, rows, residues = OPM_CASES[case]
    rng = np.random.default_rng(19)
    tdt = DTYPES[dtype][1]
    mask_a = (rng.random((bsz, ns, ni)) < 0.8).astype(np.float32)
    mask_b = (rng.random((bsz, ns, nj)) < 0.8).astype(np.float32)
    for m in (mask_a, mask_b):
        m[:, list(rows)] = 0.0
        m[..., list(residues)] = 0.0
    t = {"a": torch.as_tensor(normal(rng, (bsz, ns, ni, c)) * mask_a[..., None]).to(tdt),
         "b_full": torch.as_tensor(normal(rng, (bsz, ns, nj, c))
                                   * mask_b[..., None]).to(tdt),
         "mask_a": torch.as_tensor(mask_a), "mask_b": torch.as_tensor(mask_b),
         "w": torch.as_tensor(normal(rng, (c * c, d), 1.0 / c)).to(tdt),
         "bias": torch.as_tensor(normal(rng, (d,)))}
    j = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in t.items()}
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(OPM_CASES))
def test_opm_schedule_matches_the_references(case, dtype):
    t, j = _opm_inputs(case, dtype)
    residues = OPM_CASES[case][-1]
    out = emulate_opm(*t.values())
    bsz, _, ni, nj, _, d = OPM_CASES[case][:6]
    assert out.dtype == t["a"].dtype and out.shape == (bsz, ni, nj, d)
    tol = MODULE_TOL[dtype]
    want = jtri.fused_opm_pallas(*j.values(), interpret=True)
    assert_close(out, want, tol, "vs interpret-mode Pallas")
    assert_close(out, ref.outer_product_mean_ref(*t.values()), tol,
                 "vs the plain version")
    # norm = 0 at a fully masked residue: the output is the bias.
    r = residues[0]
    assert torch.equal(out[:, r], t["bias"].to(out.dtype).expand_as(out[:, r]))


def test_reciprocal_moves_ov_by_one_ulp_at_most():
    """One fp32 reciprocal a pixel, multiplied, where the references divide:
    on the same fp32 sums some bf16 ov elements take the neighbouring
    value, none moves further."""
    rng = np.random.default_rng(5)
    ns, npix, c = 128, 512, 32
    a = torch.as_tensor(normal(rng, (ns, npix, c))).to(torch.bfloat16).float()
    b = torch.as_tensor(normal(rng, (ns, npix, c))).to(torch.bfloat16).float()
    keep = torch.as_tensor(rng.random((ns, npix)) < 0.9).float()
    o = torch.einsum("spx,spy->pxy", a * keep[..., None], b * keep[..., None])
    den = keep.sum(0) + NORM_EPS
    by_div = (o / den[:, None, None]).to(torch.bfloat16)
    by_rcp = (o * torch.reciprocal(den)[:, None, None]).to(torch.bfloat16)
    bits = lambda t: t.view(torch.int16).long()
    ulps = (bits(by_div) - bits(by_rcp)).abs()
    assert int(ulps.max()) == 1                 # the bits do change, by one ulp
    assert float((ulps > 0).float().mean()) < 1e-3


def test_opm_schedule_does_not_depend_on_the_grid():
    """The walk and the chunk order change with the number of blocks; the
    result moves only by fp32 summation order."""
    t, _ = _opm_inputs("full-width-c32", "float32")
    one = emulate_opm(*t.values(), n_sm=1)
    many = emulate_opm(*t.values(), n_sm=5)
    assert_close(many, one, 1e-5, "1 vs 5 blocks")


# ---------------------------------------------------------------------------
# 3. K1: the vector path's partition of a row
# ---------------------------------------------------------------------------


def lane_elements(c: int, itemsize: int) -> list[list[int]]:
    """The elements each lane of a row group holds, in the order it sums
    them: the vector kernel's vectors l, l + lanes, ... of 16 bytes; where
    ``ln_partition`` gives None, the loop kernel's l, l + 32, ..."""
    part = ln_partition(c, itemsize)
    if part is None:
        return [list(range(lane, c, 32)) for lane in range(32)]
    lanes, nvl, per_vec = part
    return [[(lane + k * lanes) * per_vec + e for k in range(nvl)
             for e in range(per_vec)] for lane in range(lanes)]


def butterfly(vals: torch.Tensor) -> torch.Tensor:
    """Shuffle-xor sum over the last axis (a power of two), as the lanes
    exchange it: every lane ends with the total, summed in the tree's order."""
    v = vals.clone()
    n = v.shape[-1]
    off = n // 2
    while off:
        v = v + v[..., torch.arange(n) ^ off]
        off //= 2
    return v[..., 0]


def emulate_ln(x, gamma, beta, eps=1e-5):
    """LayerNorm by K1's schedule: per-lane fp32 sums of the row's
    elements, butterflies for the mean and the variance, in x's dtype."""
    c = x.shape[-1]
    lanes = lane_elements(c, x.element_size())
    xf = x.float().reshape(-1, c)
    width = max(len(e) for e in lanes)
    sel = torch.tensor([e + [0] * (width - len(e)) for e in lanes])
    valid = torch.tensor([[1.0] * len(e) + [0.0] * (width - len(e)) for e in lanes])
    held = xf[:, sel] * valid                                # (rows, lanes, width)
    mean = butterfly(held.sum(-1)) / c
    dev = (held - mean[:, None, None]) * valid
    inv = torch.rsqrt(butterfly(dev.square().sum(-1)) / c + eps)
    y = (xf - mean[:, None]) * inv[:, None] * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("c", [8, 16, 128, 256, 384, 1000, 2048])
def test_ln_partition_covers_each_element_once(c, itemsize):
    part = ln_partition(c, itemsize)
    elems = lane_elements(c, itemsize)
    assert sorted(e for lane in elems for e in lane) == list(range(c))
    if part is None:
        # Not whole 16-byte vectors, or more than the register envelope a
        # lane once the vectors are spread over the most lanes that divide
        # them (C = 1000: 125 bf16 vectors on one lane, 250 fp32 on two).
        per_vec = 16 // itemsize
        nv = c // per_vec
        most = max(n for n in (1, 2, 4, 8, 16, 32) if nv % n == 0)
        assert c % per_vec or nv // most > MAX_VECTORS_PER_LANE
        return
    lanes, nvl, per_vec = part
    assert per_vec * itemsize == 16 and lanes in (1, 2, 4, 8, 16, 32)
    assert 1 <= nvl <= MAX_VECTORS_PER_LANE and lanes * nvl * per_vec == c
    # A row group's k-th vectors are contiguous: lane l reads bytes
    # 16 (l + k lanes) .. + 16.
    for k in range(nvl):
        firsts = [elems[lane][k * per_vec] for lane in range(lanes)]
        assert firsts == [(lane + k * lanes) * per_vec for lane in range(lanes)]


def test_ln_partition_main_path():
    """MSA rows (C = 256): a warp a row, one vector a lane; pair rows (C =
    128): two rows a warp; the structure module's C = 384: 16 lanes, three
    vectors each; C = 1000 and 32768 take the loop kernel."""
    assert ln_partition(256, 2) == (32, 1, 8)
    assert ln_partition(128, 2) == (16, 1, 8)
    assert ln_partition(384, 2) == (16, 3, 8)
    assert ln_partition(1000, 2) is None and ln_partition(32768, 2) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 8), (3, 7, 16), (2, 3, 128), (4, 256),
                                   (2, 3, 384), (3, 1000)])
def test_ln_schedule_matches_the_references(shape, dtype):
    rng = np.random.default_rng(1)
    c = shape[-1]
    tdt = DTYPES[dtype][1]
    x = torch.as_tensor(normal(rng, shape, 2.0) + 0.5).to(tdt)
    gamma = torch.as_tensor(1.0 + normal(rng, (c,), 0.1))
    beta = torch.as_tensor(normal(rng, (c,), 0.1))
    got = emulate_ln(x, gamma, beta)
    tol = MODULE_TOL[dtype]
    assert_close(got, ref.layer_norm_ref(x, gamma, beta), tol, "vs the plain version")
    jx = jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][0])
    want = jln.layer_norm_pallas(jx, jnp.asarray(gamma.numpy()),
                                 jnp.asarray(beta.numpy()), interpret=True)
    assert_close(got, want, tol, "vs interpret-mode Pallas")
