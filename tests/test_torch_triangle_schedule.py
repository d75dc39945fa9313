"""What surrounds the fused triangle kernel (K7), on the CPU: the kernel
itself runs only on the card (tests/test_torch_cuda.py).

1. The layout: ``triangle_workspace`` of ``repro_torch.kernels.triangle``
   (the offsets and size of the bf16 workspace the wrapper allocates), and
   ``fragment_slot`` here (where an element of a 16 x 16 tile lies in the
   mma.sync fragment order the pre-pass of ``csrc/triangle_mult.cu``
   writes).
2. A plain-torch emulation of K7's schedule: the pre-pass (a gated with
   the reference's two rounding points, then a and b written in fragment
   order into one flat workspace, zero-padded to whole tiles, and w_out^T
   beside them), the main loop (the fragments read back, the per-channel
   products summed in fp32 one 16-wide k tile after another) and the
   epilogue (two-pass LN statistics, y rounded to the dtype, the
   projection with w_out^T from the workspace, bias, gate, one cast). It is
   held against the reference's interpret-mode Pallas kernel
   ``fused_triangle_pallas`` and the port's plain version
   ``ref.triangle_mult_ref``. The emulation lives here; nothing on the main
   path uses it.

Tolerances: max|emulation - reference| <= tol * max(1, max|reference|),
tol 1e-4 in fp32 (the same sums in another order) and 2e-2 in bf16 (a sum
landing on the other side of a rounding of y moves the output by a bf16
ulp of an operand), for the output and the LN mean and inv alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import triangle as jtri
from repro_torch.kernels import ref
from repro_torch.kernels import triangle as tri
from torch_parity import DTYPES, MODULE_TOL, assert_close, normal

T = tri.TRI_TILE
LANES = 32
EPS = 1e-5


def fragment_slot(row: int, k: int) -> tuple[int, int]:
    """Where element (row, k) of a 16 x 16 tile lies in its fragment: the
    lane (0..31) and the bf16 element (0..7) of that lane's 16 bytes.
    Register r = element // 2 holds rows + 8 * (r % 2) and k + 8 * (r // 2)
    (mma.sync's A operand order, which ldmatrix x4 would also give); a b
    tile (rows j) serves as the B operand of two n8 products, registers
    (0, 2) for j 0..7 and (1, 3) for j 8..15."""
    lane = (row % 8) * 4 + (k % 8) // 2
    return lane, 2 * (row // 8 + 2 * (k // 8)) + k % 2


# ---------------------------------------------------------------------------
# 1. Layout helpers
# ---------------------------------------------------------------------------


def test_fragment_slot_is_a_bijection():
    seen = {fragment_slot(r, k) for r in range(T) for k in range(T)}
    assert seen == {(lane, e) for lane in range(LANES)
                    for e in range(8)}


def test_fragment_slot_is_the_mma_operand_order():
    """Lane l holds rows l // 4 (+ 8) and k pairs 2 (l % 4) (+ 8): register
    r = element // 2 of mma.sync's A operand is (rows + 8 (r % 2), k + 8
    (r // 2)); a b tile gives the B operand of its two n8 products from
    registers (0, 2) and (1, 3)."""
    for r in range(T):
        for k in range(T):
            lane, e = fragment_slot(r, k)
            assert (lane // 4, 2 * (lane % 4)) == (r % 8, k % 8 - k % 2)
            reg, half = divmod(e, 2)
            assert (reg % 2, reg // 2, half) == (r // 8, k // 8, k % 2)


# (B, I, J, K, C, D): the main path's calls (r = 256 and 384, C = D = 128)
# and ragged ones.
WORKSPACES = [(1, 256, 256, 256, 128, 128), (1, 384, 384, 384, 128, 128),
              (2, 17, 130, 200, 32, 16), (1, 5, 3, 0, 32, 32)]


@pytest.mark.parametrize("bsz,ni,nj,nk,c,d", WORKSPACES)
def test_triangle_workspace(bsz, ni, nj, nk, c, d):
    lay = tri.triangle_workspace(bsz, ni, nj, nk, c, d)
    pad = lambda n: -(-n // T) * T
    assert lay["a"] == 0
    assert lay["b"] == bsz * c * pad(ni) * pad(nk)
    assert lay["w"] - lay["b"] == bsz * c * pad(nj) * pad(nk)
    assert lay["numel"] - lay["w"] == c * d
    assert (lay["row_tiles_a"], lay["row_tiles_b"], lay["k_tiles"]) == (
        pad(ni) // T, pad(nj) // T, pad(nk) // T)
    # Every part starts on a 16-byte boundary of the bf16 buffer.
    assert all(lay[p] % 8 == 0 for p in ("a", "b", "w"))
    if (ni, nj, nk) == (256, 256, 256):
        # Twice a_lin's size and w_out^T: 33.6 MB of bf16 at r = 256 (the
        # (B, I, J, C) fp32 product the kernel never forms would be 33.5).
        assert lay["numel"] == 2 * 256 * 256 * 128 + 128 * 128


# ---------------------------------------------------------------------------
# 2. Emulation of the schedule
# ---------------------------------------------------------------------------


def _slots():
    lane = torch.empty((T, T), dtype=torch.long)
    elem = torch.empty((T, T), dtype=torch.long)
    for r in range(T):
        for k in range(T):
            lane[r, k], elem[r, k] = fragment_slot(r, k)
    return lane, elem


def to_fragments(x):
    """(B, C, R, K) with R, K multiples of 16 -> (B, C, R/16, K/16, 32, 8)
    in fragment order."""
    b, c, nr, nk = x.shape
    tiles = x.reshape(b, c, nr // T, T, nk // T, T).permute(0, 1, 2, 4, 3, 5)
    out = torch.zeros((b, c, nr // T, nk // T, LANES, 8),
                      dtype=x.dtype)
    lane, elem = _slots()
    out[..., lane, elem] = tiles
    return out


def from_fragments(f):
    """The inverse of ``to_fragments``."""
    b, c, tr, tk = f.shape[:4]
    lane, elem = _slots()
    tiles = f[..., lane, elem]                         # (B, C, tr, tk, 16, 16)
    return tiles.permute(0, 1, 2, 4, 3, 5).reshape(b, c, tr * T, tk * T)


def prepass(a_lin, ga, mask, b_full, w_out):
    """The workspace as the pre-pass writes it, and its layout."""
    dt = a_lin.dtype
    bsz, ni, nk, c = a_lin.shape
    nj, d = b_full.shape[1], w_out.shape[1]
    lay = tri.triangle_workspace(bsz, ni, nj, nk, c, d)
    # The reference's two rounding points: (a_lin * sigmoid(ga)) in the
    # dtype, then times the mask in the dtype.
    a = (a_lin.float() * torch.sigmoid(ga.float())).to(dt) * mask.to(dt)[..., None]

    def padded(x, tiles):                              # (B, R, K, C) -> (B, C, Rp, Kp)
        out = torch.zeros((bsz, c, tiles * T, lay["k_tiles"] * T), dtype=dt)
        out[:, :, :x.shape[1], :nk] = x.permute(0, 3, 1, 2)
        return out

    ws = torch.zeros(lay["numel"], dtype=dt)
    ws[lay["a"]:lay["b"]] = to_fragments(padded(a, lay["row_tiles_a"])).reshape(-1)
    ws[lay["b"]:lay["w"]] = to_fragments(padded(b_full, lay["row_tiles_b"])).reshape(-1)
    ws[lay["w"]:] = w_out.t().to(dt).reshape(-1)
    return ws, lay


def emulate(a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
            g_bias, eps=EPS):
    """(out, mean, inv) by K7's schedule."""
    dt = a_lin.dtype
    bsz, ni, nk, c = a_lin.shape
    nj, d = b_full.shape[1], w_out.shape[1]
    ws, lay = prepass(a_lin, ga, mask, b_full, w_out)
    tk = lay["k_tiles"]
    fa = ws[lay["a"]:lay["b"]].view(bsz, c, lay["row_tiles_a"], tk, 32, 8)
    fb = ws[lay["b"]:lay["w"]].view(bsz, c, lay["row_tiles_b"], tk, 32, 8)
    a_t, b_t = from_fragments(fa).float(), from_fragments(fb).float()
    # Main loop: per channel, fp32 sums over one 16-wide k tile at a time.
    acc = torch.zeros((bsz, c, a_t.shape[2], b_t.shape[2]))
    for k0 in range(0, tk * T, T):
        acc += a_t[..., k0:k0 + T] @ b_t[..., k0:k0 + T].transpose(-1, -2)
    # Epilogue.
    o = acc[:, :, :ni, :nj].permute(0, 2, 3, 1)        # (B, I, J, C)
    mean = o.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((o - mean).square().mean(dim=-1, keepdim=True) + eps)
    y = ((o - mean) * inv * gamma.float() + beta.float()).to(dt)
    w_t = ws[lay["w"]:].view(d, c)
    z = y.float() @ w_t.float().t() + b_out.float()
    s = torch.sigmoid(g_lin.float() + g_bias.float())
    return (s * z).to(dt), mean[..., 0], inv[..., 0]


# (case, B, I, J, K, C, D, incoming, rows i whose every k is masked): the
# outgoing layout (a_lin, ga column halves of a merged (B, I, K, 2C)
# projection), the incoming one (of a (B, K, I, 2C) projection read
# transposed, the mask a transposed view), and I, J, K off the tiles.
CASES = [
    ("outgoing", 1, 24, 24, 24, 32, 32, False, (3,)),
    ("incoming-b2", 2, 17, 20, 19, 32, 16, True, (0, 5)),
    ("off-tile", 1, 17, 130, 200, 16, 8, False, (2,)),
]


def _inputs(rng, bsz, ni, nj, nk, c, d, incoming, masked, dtype):
    tdt = DTYPES[dtype][1]
    proj = (bsz, nk, ni, 2 * c) if incoming else (bsz, ni, nk, 2 * c)
    ab = torch.as_tensor(normal(rng, proj)).to(tdt)
    g = torch.as_tensor(normal(rng, proj, 2.0)).to(tdt)
    keep = (rng.random((bsz, nk, ni) if incoming else (bsz, ni, nk))
            < 0.8).astype(np.float32)
    mask = torch.as_tensor(keep)
    if incoming:
        ab, g, mask = ab.transpose(1, 2), g.transpose(1, 2), mask.transpose(1, 2)
    mask[:, list(masked)] = 0.0
    t = {"a_lin": ab[..., :c], "ga": g[..., :c], "mask": mask,
         "b_full": torch.as_tensor(normal(rng, (bsz, nj, nk, c))).to(tdt),
         "gamma": torch.as_tensor(1.0 + normal(rng, (c,), 0.1)),
         "beta": torch.as_tensor(normal(rng, (c,), 0.1)),
         "w_out": torch.as_tensor(normal(rng, (c, d), c ** -0.5)),
         "b_out": torch.as_tensor(normal(rng, (d,), 0.1)),
         "g_lin": torch.as_tensor(normal(rng, (bsz, ni, nj, d), 2.0)).to(tdt),
         "g_bias": torch.as_tensor(normal(rng, (d,)))}
    # The same values, dense, for the reference.
    j = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in t.items()}
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,bsz,ni,nj,nk,c,d,incoming,masked", CASES,
                         ids=[c[0] for c in CASES])
def test_schedule_matches_the_references(case, bsz, ni, nj, nk, c, d,
                                         incoming, masked, dtype):
    rng = np.random.default_rng(18)
    t, j = _inputs(rng, bsz, ni, nj, nk, c, d, incoming, masked, dtype)
    if incoming:
        assert not t["a_lin"].is_contiguous() and not t["mask"].is_contiguous()
    out, mean, inv = emulate(*t.values())
    assert out.dtype == t["g_lin"].dtype and out.shape == (bsz, ni, nj, d)
    tol = MODULE_TOL[dtype]
    want, want_mean, want_inv = jtri.fused_triangle_pallas(*j.values(),
                                                           interpret=True)
    assert_close(out, want, tol, "vs interpret-mode Pallas")
    assert_close(mean, want_mean, tol, "mean vs Pallas")
    assert_close(inv, want_inv, tol, "inv vs Pallas")
    plain, plain_mean, plain_inv = ref.triangle_mult_ref(*t.values())
    assert_close(out, plain, tol, "vs the plain version")
    assert_close(mean, plain_mean, tol, "mean vs the plain version")
    assert_close(inv, plain_inv, tol, "inv vs the plain version")
    # A fully masked a row: LN of zeros, (0 - 0) * rsqrt(eps).
    rows = list(masked)
    assert float(mean[:, rows].abs().max()) == 0.0
    np.testing.assert_allclose(inv[:, rows].numpy(), EPS ** -0.5, rtol=1e-6)


def test_fragments_round_trip_and_padding():
    """The fragment order holds every element once; the pre-pass's padding
    rows and k columns are zeros, so the ragged main loop needs no mask."""
    rng = np.random.default_rng(3)
    t, _ = _inputs(rng, 1, 17, 9, 21, 32, 32, False, (), "bfloat16")
    ws, lay = prepass(t["a_lin"], t["ga"], t["mask"], t["b_full"], t["w_out"])
    fa = ws[lay["a"]:lay["b"]].view(1, 32, 2, 2, 32, 8)
    a_t = from_fragments(fa)                            # (1, C, 32, 32)
    gated = ((t["a_lin"].float() * torch.sigmoid(t["ga"].float()))
             .to(torch.bfloat16) * t["mask"].to(torch.bfloat16)[..., None])
    assert torch.equal(a_t[:, :, :17, :21], gated.permute(0, 3, 1, 2))
    assert not a_t[:, :, 17:].any() and not a_t[:, :, :, 21:].any()
    assert torch.equal(to_fragments(a_t), fa)
    w_t = ws[lay["w"]:].view(32, 32)
    assert torch.equal(w_t, t["w_out"].t().to(torch.bfloat16))
