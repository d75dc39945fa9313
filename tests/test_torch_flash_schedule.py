"""What surrounds the tensor-core flash-attention kernels (K5, K6), on the
CPU: the kernels themselves run only on the card (tests/test_torch_cuda.py).

1. The wrappers' host-side choices, each a plain function of
   ``repro_torch.kernels.flash_attention``: G (how many consecutive groups
   of one bias batch a block runs over one staged bias slice), the
   backward's fp32 bias-gradient partials, and which strided views are
   copied before the 16-byte copies of the kernels.
2. A plain-torch emulation of the kernels' blocked schedule (64-key tiles
   with an online softmax, P rounded to bf16 unnormalised; the backward's
   two sweeps with P and dS rounded to bf16 as product operands, dbias as
   one fp32 partial per chunk of G groups, summed in a fixed order), held
   against the reference's interpret-mode Pallas kernels
   ``flash_attention_pallas`` and ``flash_attention_bwd_pallas``. The
   emulation lives here; nothing on the main path uses it.

Tolerances: max|emulation - reference| <= tol * max(1, max|reference|),
tol 1e-4 in fp32 (the same sums in another order) and 2e-2 in bf16 (P and
dS rounded to bf16 where the reference keeps them fp32; one bf16 rounding
is 2**-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import (flash_attention_bwd_pallas,
                                           flash_attention_pallas)
from repro_torch.kernels import flash_attention as fa
from torch_parity import MODULE_TOL, assert_close, both, normal

# ---------------------------------------------------------------------------
# 1. Host-side choices
# ---------------------------------------------------------------------------

# (name, N, Sq, Skv, H, rep or None, forward G, backward G): the main path's
# calls at FULL width (MSA row, MSA column, triangle start/end; r = 256,
# 384 and 2048, s = 128) and edge shapes. Above 384 keys the forward
# streams its bias and runs G groups side by side.
SCHEDULES = [
    ("msa-row-r256", 128, 256, 256, 8, 128, 4, 8),
    ("msa-row-r384", 128, 384, 384, 8, 128, 4, 8),
    ("msa-col-r256", 256, 128, 128, 8, None, 1, 1),
    ("msa-col-r384", 384, 128, 128, 8, None, 1, 1),
    ("triangle-r256", 256, 256, 256, 4, 256, 4, 8),
    ("triangle-r384", 384, 384, 384, 4, 384, 8, 8),
    ("rep1", 64, 256, 256, 4, 1, 1, 1),
    ("rep3-small-grid", 6, 40, 40, 2, 3, 1, 1),
    ("rep12", 1536, 256, 256, 4, 12, 4, 4),
    ("skv-past-staging", 256, 64, 600, 4, 256, 1, 1),
    ("sq-past-staging", 256, 600, 64, 4, 256, 8, 1),
    ("triangle-r2048", 2048, 2048, 2048, 4, 2048, 2, 1),
    ("msa-row-r2048", 128, 2048, 2048, 8, 128, 2, 1),
]


@pytest.mark.parametrize("name,n,sq,skv,h,rep,g_fwd,g_bwd", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_groups_per_block(name, n, sq, skv, h, rep, g_fwd, g_bwd):
    got_fwd = fa.fwd_groups(n, sq, skv, h, rep)
    got_bwd = fa.bwd_groups(n, sq, skv, h, rep)
    assert (got_fwd, got_bwd) == (g_fwd, g_bwd)
    for g, kind in ((got_fwd, "fwd"), (got_bwd, "bwd")):
        assert g in fa.GROUP_CHOICES
        assert n % g == 0 and (rep or 1) % g == 0, kind
    if fa.streamed(skv, rep):
        assert got_fwd in fa.STREAM_GROUP_CHOICES
        assert fa.stream_smem_bytes(max(fa.HEAD_DIMS), got_fwd) <= fa.MAX_SMEM
    # A G above 1 leaves the grid its least number of blocks.
    if got_fwd > 1:
        assert fa._tiles(sq) * h * n // got_fwd >= fa.FWD_MIN_BLOCKS
    if got_bwd > 1:
        assert (min(fa._tiles(sq), fa._tiles(skv)) * h * n // got_bwd
                >= fa.BWD_MIN_BLOCKS)


@pytest.mark.parametrize("name,n,sq,skv,h,rep,g_fwd,g_bwd", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_dbias_partials_shape(name, n, sq, skv, h, rep, g_fwd, g_bwd):
    shape = fa.dbias_partials_shape(n, h, sq, skv, rep, g_bwd)
    if rep is None or rep == 1:
        assert shape is None            # no bias, or dbias written directly
        return
    assert shape == (n // g_bwd, h, sq, skv)
    # A bias batch's rep / G partials are consecutive.
    assert (n // rep) * (rep // g_bwd) == shape[0]


def test_dbias_scratch_size_at_the_main_path():
    """About 34 MB of fp32 partials for an MSA-row or triangle call at
    r = 256 (G = 8)."""
    for n, h in ((128, 8), (256, 4)):
        g = fa.bwd_groups(n, 256, 256, h, n)
        shape = fa.dbias_partials_shape(n, h, 256, 256, n, g)
        assert np.prod(shape) * 4 == 33_554_432


def test_groups_checked():
    """Staged: any G dividing rep and N; the forward's streamed bias: G 2
    or 1; otherwise (no bias, the backward's unstaged slices) only 1."""
    fa._check_groups("k", 4, 8, 16, None)
    fa._check_groups("k", 2, 8, 16, fa.STREAM_GROUP_CHOICES)
    for groups, rep, n, choices in ((3, 8, 16, None), (4, 2, 16, None),
                                    (4, 8, 6, None), (2, 8, 16, (1,)),
                                    (4, 8, 16, fa.STREAM_GROUP_CHOICES),
                                    (0, 1, 4, None)):
        with pytest.raises(ValueError, match="G ="):
            fa._check_groups("k", groups, rep, n, choices)


def _qkv_buffer(n, s, h, d, extra=0, offset=0):
    w = 3 * h * d + extra
    buf = torch.zeros(n * s * w + 16, dtype=torch.bfloat16)
    return [buf[offset + i * h * d:].as_strided((n, s, h, d),
                                                (s * w, w, d, 1))
            for i in range(3)]


@pytest.mark.parametrize("d", [16, 32])
def test_copy_for_kernel(d):
    n, s, h = 3, 10, 2
    # Aligned: contiguous, and column slices of a merged projection.
    assert not fa.copy_for_kernel(torch.zeros((n, s, h, d),
                                              dtype=torch.bfloat16))
    assert not any(fa.copy_for_kernel(t) for t in _qkv_buffer(n, s, h, d))
    # Copied: an odd element offset (pointer), an S stride that is not a
    # multiple of 8 elements, an N stride that is not.
    assert all(fa.copy_for_kernel(t) for t in _qkv_buffer(n, s, h, d,
                                                          offset=1))
    assert all(fa.copy_for_kernel(t) for t in _qkv_buffer(n, s, h, d,
                                                          extra=2))
    base = torch.zeros(n * (s * h * d + 4), dtype=torch.bfloat16)
    odd_n = base.as_strided((n, s, h, d), (s * h * d + 4 - 2, h * d, d, 1))
    assert fa.copy_for_kernel(odd_n)
    # The wrappers' operand check copies such a view to a contiguous,
    # aligned tensor with the same values; aligned views and fp32 views pass
    # through untouched.
    src = _qkv_buffer(n, s, h, d, extra=2, offset=1)[1]
    src.copy_(torch.randn(src.shape).to(torch.bfloat16))
    got, sn, ss = fa._operand("f", "k", src, (n, s, h, d), torch.bfloat16,
                              src.get_device())
    assert got.is_contiguous() and not fa.copy_for_kernel(got)
    assert torch.equal(got, src) and (sn, ss) == got.stride()[:2]
    view = _qkv_buffer(n, s, h, d)[2]
    assert fa._operand("f", "v", view, (n, s, h, d), torch.bfloat16,
                       view.get_device())[0] is view
    f32 = torch.zeros(n * s * (3 * h * d + 1) + 8)[1:].as_strided(
        (n, s, h, d), (s * (3 * h * d + 1), 3 * h * d + 1, d, 1))
    assert fa._operand("f", "q", f32, (n, s, h, d), torch.float32,
                       f32.get_device())[0] is f32
    with pytest.raises(ValueError, match="dense"):
        fa._operand("f", "q", f32.transpose(2, 3).contiguous().transpose(2, 3),
                    (n, s, h, d), torch.float32, -1)


# ---------------------------------------------------------------------------
# 2. The blocked schedule against the reference's Pallas kernels
# ---------------------------------------------------------------------------

TILE = fa.TILE


def _bias_full(bias, n):
    """(B, H, Sq, Skv) -> (N, H, Sq, Skv) fp32, batch n // rep."""
    return bias.float().repeat_interleave(n // bias.shape[0], dim=0)


def emulate_fwd(q, k, v, bias, mask, scale, bf16):
    """The bf16 forward kernel's schedule: KV tiles of 64 keys, an online
    softmax, s = x * scale + bias + mask in fp32, P rounded to bf16
    unnormalised (in bf16) before P V, out and lse written at the end."""
    n, sq, h, d = q.shape
    skv = k.shape[1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (N, H, S, D)
    b = _bias_full(bias, n) if bias is not None else None
    m = torch.full((n, h, sq), -1e30)
    l = torch.zeros((n, h, sq))
    acc = torch.zeros((n, h, sq, d))
    for j0 in range(0, skv, TILE):
        j1 = min(j0 + TILE, skv)
        s = qf @ kf[:, :, j0:j1].transpose(-1, -2) * scale
        if b is not None:
            s = s + b[..., j0:j1]
        if mask is not None:
            s = s + mask[:, None, None, j0:j1]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pr = p.to(torch.bfloat16).float() if bf16 else p
        acc = acc * alpha[..., None] + pr @ vf[:, :, j0:j1]
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


def emulate_bwd(q, k, v, out, do, lse, bias, mask, scale, groups, bf16):
    """The bf16 backward's two sweeps over 64-row/64-key tiles. P and dS are
    rounded to bf16 (in bf16) as the operands of their products; dbias is
    one fp32 partial per chunk of G consecutive groups (rep = 1: each dS
    tile is dbias), the rep / G partials of a bias batch summed in order;
    dmask sums dS over query rows per head, then over heads in order."""
    n, sq, h, d = q.shape
    skv = k.shape[1]
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, do))
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)   # (N, H, Sq)
    b = _bias_full(bias, n) if bias is not None else None
    rep = n // bias.shape[0] if bias is not None else 1

    def tile(nn, i0, i1, j0, j1):
        s = qf[nn, :, i0:i1] @ kf[nn, :, j0:j1].transpose(-1, -2) * scale
        if b is not None:
            s = s + b[nn, :, i0:i1, j0:j1]
        if mask is not None:
            s = s + mask[nn, j0:j1]
        p = torch.exp(s - lse[nn, :, i0:i1, None])
        dp = gf[nn, :, i0:i1] @ vf[nn, :, j0:j1].transpose(-1, -2)
        return p, p * (dp - delta[nn, :, i0:i1, None])

    # dq sweep: blocks of (64 query rows, G groups); the slab sums dS over
    # the chunk's groups.
    dq = torch.zeros((n, h, sq, d))
    parts = torch.zeros((n // groups, h, sq, skv)) if rep > 1 else None
    dbias = torch.zeros((n, h, sq, skv)) if bias is not None and rep == 1 else None
    for c in range(n // groups):
        for i0 in range(0, sq, TILE):
            i1 = min(i0 + TILE, sq)
            for nn in range(c * groups, (c + 1) * groups):
                for j0 in range(0, skv, TILE):
                    j1 = min(j0 + TILE, skv)
                    _, ds = tile(nn, i0, i1, j0, j1)
                    dq[nn, :, i0:i1] += rnd(ds) @ kf[nn, :, j0:j1]
                    if dbias is not None:
                        dbias[nn, :, i0:i1, j0:j1] = ds
                    elif parts is not None:
                        parts[c, :, i0:i1, j0:j1] += ds
    # dk/dv sweep: blocks of (64 keys, G groups) over the query tiles.
    dk = torch.zeros((n, h, skv, d))
    dv = torch.zeros((n, h, skv, d))
    dmask_h = torch.zeros((n, h, skv))
    for nn in range(n):
        for j0 in range(0, skv, TILE):
            j1 = min(j0 + TILE, skv)
            for i0 in range(0, sq, TILE):
                i1 = min(i0 + TILE, sq)
                p, ds = tile(nn, i0, i1, j0, j1)
                dv[nn, :, j0:j1] += rnd(p).transpose(-1, -2) @ gf[nn, :, i0:i1]
                dk[nn, :, j0:j1] += rnd(ds).transpose(-1, -2) @ qf[nn, :, i0:i1]
                dmask_h[nn, :, j0:j1] += ds.sum(-2)
    if parts is not None:
        per = rep // groups
        dbias = torch.zeros((n // rep, h, sq, skv))
        for bb in range(n // rep):
            for i in range(per):
                dbias[bb] += parts[bb * per + i]
    dmask = None
    if mask is not None:
        dmask = torch.zeros((n, skv))
        for hh in range(h):
            dmask += dmask_h[:, hh]
    cast = lambda t: t.transpose(1, 2).to(q.dtype)
    return (cast(dq * scale), cast(dk * scale), cast(dv),
            dbias.to(bias.dtype) if dbias is not None else None, dmask)


def reference_fwd_bwd(q, k, v, bias, mask, do, scale):
    """The reference's interpret-mode Pallas forward and backward, staged
    into their padded kernel layout as the reference's ops stage them."""
    n, sq, h, d = q.shape
    skv = k.shape[1]
    qt, kt, vt, bt, mt, q_tile, kv_t, sq_pad, skv_pad = jops._attn_stage_padded(
        0, q, k, v, bias, mask)
    flags = dict(scale=scale, kv_len=skv, q_tile=q_tile, kv_tile=kv_t,
                 has_bias=bias is not None, has_mask=mask is not None,
                 interpret=True)
    out_p, lse_p = flash_attention_pallas(qt, kt, vt, bt, mt, **flags)
    out = out_p[:, :, :sq, :d].transpose(0, 2, 1, 3)
    lse = lse_p[:, :, :sq]
    delta = jnp.einsum("nqhd,nqhd->nhq", do.astype(jnp.float32),
                       out.astype(jnp.float32))
    dot = jops._pad_nhsd(do.astype(q.dtype).transpose(0, 2, 1, 3), sq_pad,
                         qt.shape[-1])
    pad = ((0, 0), (0, 0), (0, sq_pad - sq))
    dq, dk, dv, dbias, dmask_h = flash_attention_bwd_pallas(
        qt, kt, vt, dot, jnp.pad(lse, pad), jnp.pad(delta, pad), bt, mt,
        **flags)
    grads = (dq[:, :, :sq, :d].transpose(0, 2, 1, 3),
             dk[:, :, :skv, :d].transpose(0, 2, 1, 3),
             dv[:, :, :skv, :d].transpose(0, 2, 1, 3),
             dbias[:, :, :sq, :skv] if bias is not None else None,
             dmask_h.sum(axis=1)[:, :skv] if mask is not None else None)
    return out, lse, grads


# (N, Sq, Skv, H, D, B, bias, mask, fully masked rows, G): ragged Sq and
# Skv, rep > G with rep a multiple of G, rep = 1, fully masked rows (the
# reference's flash backward takes p = 1 on each of their keys, R4), no
# bias, Sq < 16, D 16 and 32.
BLOCKED_CASES = {
    "ragged-rep2-g2": (4, 70, 90, 2, 32, 2, True, True, (), 2),
    "rep8-g4-d16": (8, 33, 70, 2, 16, 1, True, True, (), 4),
    "rep1": (3, 20, 45, 2, 32, 3, True, True, (), 1),
    "fully-masked-rows": (4, 40, 40, 2, 32, 2, True, True, (1,), 2),
    "no-bias": (3, 66, 130, 1, 16, 0, False, True, (), 1),
    "sq5-rep4-g2": (4, 5, 9, 2, 32, 1, True, True, (0,), 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_schedule_matches_reference(case, dtype):
    n, sq, skv, h, d, nb, wb, wm, masked, groups = BLOCKED_CASES[case]
    rng = np.random.default_rng(31)
    arrays = {"q": normal(rng, (n, sq, h, d)), "k": normal(rng, (n, skv, h, d)),
              "v": normal(rng, (n, skv, h, d)), "do": normal(rng, (n, sq, h, d)),
              "bias": normal(rng, (nb, h, sq, skv)) if wb else None}
    mask = None
    if wm:
        keep = rng.random((n, skv)) < 0.8
        keep[list(masked)] = False
        mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    j, t = {}, {}
    for name, x in arrays.items():
        j[name], t[name] = both(x, dtype) if x is not None else (None, None)
    j["mask"], t["mask"] = both(mask, "float32") if wm else (None, None)
    scale = d ** -0.5
    bf16 = dtype == "bfloat16"
    tol = MODULE_TOL[dtype]

    out, lse = emulate_fwd(t["q"], t["k"], t["v"], t["bias"], t["mask"],
                           scale, bf16)
    ref_out, ref_lse, ref_grads = reference_fwd_bwd(
        j["q"], j["k"], j["v"], j["bias"], j["mask"], j["do"], scale)
    assert_close(out, ref_out, tol, "out vs flash_attention_pallas")
    assert_close(lse, ref_lse, MODULE_TOL["float32"], "lse")

    grads = emulate_bwd(t["q"], t["k"], t["v"], out, t["do"], lse, t["bias"],
                        t["mask"], scale, groups, bf16)
    for name, got, want in zip(("dq", "dk", "dv", "dbias", "dmask"), grads,
                               ref_grads):
        assert (got is None) == (want is None), name
        if got is not None:
            assert_close(got, want, tol, f"{name} vs flash_attention_bwd_pallas")
