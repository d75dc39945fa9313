"""Launch wrappers of the fused triangular multiplicative update
(``csrc/triangle_mult.cu``) and the fused outer-product-mean
(``csrc/outer_product_mean.cu``) CUDA kernels, and their recompute
backwards.

The kernels replace ``fused_triangle_pallas`` and ``fused_opm_pallas``
(src/repro/kernels/triangle.py). The wrappers take CUDA tensors only;
``ops.fused_triangle_mult`` and ``ops.fused_outer_product_mean`` route CPU
tensors to the plain versions. The kernels choose their own tiles: the
wrappers accept AutoChunk's tile and ignore it (see each one).

K7 in bf16 is two CUDA kernels behind one launch count: a pre-pass gates
a once and writes it, with a copy of b, into a bf16 workspace in the order
of mma.sync's fragments (``triangle_workspace``); the main kernel then
reads those fragments from L2 straight into registers for its k loop and
keeps LN, the projection and the gate on chip. What bounds each stage, and
why, is in the note at the top of ``csrc/triangle_mult.cu``.

``triangle_mult_bwd`` and ``opm_bwd`` are the reference's backwards, which
it computes outside any Pallas kernel, ported to PyTorch as they are: per
block of j they rebuild the product from the saved inputs (and K7's LN
``mean``/``inv``) and the saved output, so no (B, I, J, C) or
(B, I, J, C, C) tensor is formed whole. They run the same on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TRI_WIDTHS = (32, 128)      # C and D of the triangle kernel (MINI, FULL)
OPM_C = (16, 32)            # the OPM's channel width (MINI, FULL)
OPM_D = (32, 128)           # its output width, the pair width


def _check(name: str, t: torch.Tensor, shape, dtype, device, contiguous=True):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or (contiguous and not t.is_contiguous())):
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} is "
                         f"not {'a contiguous ' if contiguous else ''}"
                         f"{tuple(shape)} {dtype} on {device}")


def _check_rows(name: str, t: torch.Tensor):
    """The kernel reads 8 channels at a time: unit channel stride, the other
    strides multiples of 8 elements, a 16-byte aligned start."""
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: strides {t.stride()} (offset "
                         f"{t.storage_offset()}) do not give 16-byte aligned "
                         "rows of 8 channels")


def _check_input(fn: str, t: torch.Tensor):
    if not t.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, got {t.device}")
    if t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {t.dtype} not in {tuple(_build.DTYPE_CODES)}")


# K7's tiles: 16 x 16 output pixels a block, k in tiles of 16; its bf16
# operands are staged in the order of mma.sync's 16 x 16 fragments.
TRI_TILE = 16


def triangle_workspace(bsz: int, ni: int, nj: int, nk: int, c: int,
                       d: int) -> dict[str, int]:
    """The layout of K7's bf16 workspace (``csrc/triangle_mult.cu``,
    ``layout``), in elements: the gated a's fragments at ``"a"``, shaped
    (B, C, ceil(I/16), ceil(K/16), 32 lanes, 8); b's at ``"b"``, (B, C,
    ceil(J/16), ceil(K/16), 32, 8); w_out^T (D, C) at ``"w"``; and the size,
    ``"numel"``. Rows past I or J and k past K are zero padding."""
    t = TRI_TILE
    ti, tj, tk = -(-ni // t), -(-nj // t), -(-nk // t)
    a = bsz * c * ti * tk * t * t
    b = bsz * c * tj * tk * t * t
    return {"a": 0, "b": a, "w": a + b, "numel": a + b + c * d,
            "row_tiles_a": ti, "row_tiles_b": tj, "k_tiles": tk}


def fused_triangle_cuda(a_lin, ga, mask, b_full, gamma, beta, w_out, b_out,
                        g_lin, g_bias, eps: float = 1e-5, tile: int = 0):
    """sigmoid(g_lin + g_bias) * (LN_C(sum_k (a_lin·σ(ga)·mask)[i,k] ⊙ b[j,k])
    @ w_out + b_out), one op: in bf16 the pre-pass (a gated once into the
    fragment-ordered workspace, b copied beside it) and the main kernel
    (the k loop on mma.sync from registers, LN and the projection on chip),
    counted as one launch; in fp32 one FMA kernel.

    a_lin, ga: (B, I, K, C) fp32 or bf16, unit channel stride, other strides
    multiples of 8; mask: (B, I, K) fp32, any strides; b_full: (B, J, K, C)
    and g_lin: (B, I, J, D), contiguous, in a_lin's dtype; gamma, beta: (C,),
    w_out: (C, D), b_out, g_bias: (D,), all fp32 contiguous. C, D in
    ``TRI_WIDTHS``. The bf16 workspace (``triangle_workspace``, about twice
    a_lin's size) is allocated here with ``torch.empty``; no (B, I, J, C)
    buffer is. ``tile`` (AutoChunk's ``tri_k_tile``) is accepted and
    ignored: the k tile is ``TRI_TILE``, fixed by the fragment layout, and
    the workspace holds the whole gated a and b, which a j or k tile would
    not shrink without a new design. Returns (out (B, I, J, D) in a_lin's
    dtype, mean and inv (B, I, J) fp32)."""
    fn = "fused_triangle_cuda"
    _check_input(fn, a_lin)
    bsz, ni, nk, c = a_lin.shape
    nj, d = b_full.shape[1], w_out.shape[-1]
    if c not in TRI_WIDTHS or d not in TRI_WIDTHS:
        raise ValueError(f"{fn}: channel widths C={c}, D={d} not in {TRI_WIDTHS}")
    # The pre-pass's grid: z = B x (C / 32 channel chunks) x (a, b); y =
    # the row tiles of I or J.
    if (bsz * (c // 32) * 2 > _build.MAX_GRID_YZ
            or -(-max(ni, nj) // 8) > _build.MAX_GRID_YZ):
        raise ValueError(f"{fn}: B={bsz}, I={ni}, J={nj} outside the "
                         "kernel's grid")
    dt, dev, f32 = a_lin.dtype, a_lin.device, torch.float32
    _check(f"{fn} ga", ga, a_lin.shape, dt, dev, contiguous=False)
    _check(f"{fn} mask", mask, (bsz, ni, nk), f32, dev, contiguous=False)
    _check(f"{fn} b_full", b_full, (bsz, nj, nk, c), dt, dev)
    _check(f"{fn} g_lin", g_lin, (bsz, ni, nj, d), dt, dev)
    for name, t, shape in (("gamma", gamma, (c,)), ("beta", beta, (c,)),
                           ("w_out", w_out, (c, d)), ("b_out", b_out, (d,)),
                           ("g_bias", g_bias, (d,))):
        _check(f"{fn} {name}", t, shape, f32, dev)
    _check_rows(f"{fn} a_lin", a_lin)
    _check_rows(f"{fn} ga", ga)
    out = torch.empty((bsz, ni, nj, d), dtype=dt, device=dev)
    mean = torch.empty((bsz, ni, nj), dtype=f32, device=dev)
    inv = torch.empty((bsz, ni, nj), dtype=f32, device=dev)
    ws, ws_numel = None, 0
    if dt == torch.bfloat16:
        ws_numel = triangle_workspace(bsz, ni, nj, nk, c, d)["numel"]
        ws = torch.empty(ws_numel, dtype=dt, device=dev)
    err = _build.entry("triangle_mult")(
        a_lin.data_ptr(), ga.data_ptr(), mask.data_ptr(), b_full.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        g_lin.data_ptr(), g_bias.data_ptr(), out.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), None if ws is None else ws.data_ptr(), ws_numel,
        *a_lin.stride()[:3], *ga.stride()[:3], *mask.stride(), bsz, ni, nj,
        nk, c, d, float(eps), _build.DTYPE_CODES[dt],
        _build.stream_handle(a_lin))
    _build.check("triangle_mult", err)
    return out, mean, inv


# (a, b_full, mask_a, mask_b, w, bias: shape, stride, dtype) -> (B, S, I,
# J, C, D, dtype code).
_OPM_GEOM: dict = {}


def _opm_geometry(fn, a, b_full, mask_a, mask_b, w, bias, key):
    """The checks that depend only on shapes, layouts and dtypes, made once
    per distinct ``key``; returns the launch geometry, cached under it."""
    if a.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {a.dtype} not in {tuple(_build.DTYPE_CODES)}")
    if a.ndim != 4 or b_full.ndim != 4 or w.ndim != 2:
        raise ValueError(f"{fn}: a {tuple(a.shape)}, b_full {tuple(b_full.shape)}"
                         f" and w {tuple(w.shape)} must be 4, 4 and 2-d")
    bsz, ns, ni, c = a.shape
    nj, d = b_full.shape[2], w.shape[-1]
    if c not in OPM_C or d not in OPM_D:
        raise ValueError(f"{fn}: channel widths C={c}, D={d} not in {OPM_C} x "
                         f"{OPM_D}")
    # fp32: a (J/4, I/4, B) grid; bf16: one persistent block an SM over
    # the 8 x 8-pixel tiles.
    if a.dtype == torch.float32 and (bsz > _build.MAX_GRID_YZ
                                     or -(-ni // 4) > _build.MAX_GRID_YZ):
        raise ValueError(f"{fn}: B={bsz}, I={ni} outside the kernel's grid")
    if bsz * -(-ni // 8) * -(-nj // 8) >= 2 ** 31:
        raise ValueError(f"{fn}: B={bsz}, I={ni}, J={nj}: too many tiles")
    # Devices are checked on every call, not here.
    dt, f32 = a.dtype, torch.float32
    for name, t, shape, dtype in (
            ("a", a, a.shape, dt), ("b_full", b_full, (bsz, ns, nj, c), dt),
            ("mask_a", mask_a, (bsz, ns, ni), f32),
            ("mask_b", mask_b, (bsz, ns, nj), f32),
            ("w", w, (c * c, d), dt), ("bias", bias, (d,), f32)):
        _check(f"{fn} {name}", t, shape, dtype, t.device)
    return _build.remember(_OPM_GEOM, key, (bsz, ns, ni, nj, c, d,
                                            _build.DTYPE_CODES[dt]))


def _opm_checked(fn, *ts):
    """The geometry of a call: cached under the shapes, strides and dtypes
    of its tensors, so that a layout or dtype not seen before is checked."""
    key = tuple((t.shape, t.stride(), t.dtype) for t in ts)
    geom = _OPM_GEOM.get(key)
    return geom if geom is not None else _opm_geometry(fn, *ts, key)


def fused_opm_cuda(a, b_full, mask_a, mask_b, w, bias, tile: int = 0):
    """(vec(sum_s a[s,i] ⊗ b[s,j]) / (sum_s mask_a·mask_b + 1e-3)) @ w + bias,
    one kernel.

    a: (B, S, I, C), b_full: (B, S, J, C), masked, contiguous, fp32 or
    bf16; mask_a (B, S, I), mask_b (B, S, J) fp32 contiguous; w: (C*C, D)
    contiguous in a's dtype; bias: (D,) fp32; all on one device, and in
    bf16 a, b_full and w 16-byte aligned (the kernel reads them through
    TMA). C in ``OPM_C``, D in ``OPM_D``. Returns (B, I, J, D) in a's dtype.
    The checks that depend only on shapes, strides and dtypes run once per
    distinct combination (``_opm_geometry``). ``tile`` (AutoChunk's
    ``opm_s_tile``) is accepted and ignored: the kernel's s stages and
    8 x 8-pixel tiles are fixed by its TMA boxes and stay on chip, and it
    allocates only its output."""
    fn = "fused_opm_cuda"
    if not a.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, got {a.device}")
    ts = (a, b_full, mask_a, mask_b, w, bias)
    bsz, ns, ni, nj, c, d, code = _opm_checked(fn, *ts)
    dev = a.get_device()
    if any(t.get_device() != dev for t in ts[1:]):
        raise ValueError(f"{fn}: every input must be on {a.device}")
    ap, bp, wp = a.data_ptr(), b_full.data_ptr(), w.data_ptr()
    if code == 1 and (ap | bp | wp) % 16:
        raise ValueError(f"{fn}: a, b_full and w must be 16-byte aligned")
    out = torch.empty((bsz, ni, nj, d), dtype=a.dtype, device=a.device)
    err = _build.entry("outer_product_mean")(
        ap, bp, mask_a.data_ptr(), mask_b.data_ptr(), wp, bias.data_ptr(),
        out.data_ptr(), bsz, ns, ni, nj, c, d, code, _build.stream_handle(a))
    _build.check("outer_product_mean", err)
    return out


# The j block of the recompute backwards: the reference's default
# (``_DEFAULT_TRI_TILE`` and ``_DEFAULT_OPM_TILE`` in src/repro/kernels/ops.py).
BWD_J_BLOCK = 128
OPM_NORM_EPS = 1e-3


def triangle_mult_bwd(eps: float, res, dout: torch.Tensor, *,
                      j_block: int = BWD_J_BLOCK, need_dmask: bool = True):
    """Recompute backward of the fused triangle update: the gradients of
    every input from the saved (a_lin, ga, mask, b_full, gamma, beta, w_out,
    b_out, g_lin, g_bias, mean, inv, out) and the cotangent ``dout``, the
    product rebuilt per block of j. Each gradient is in its input's dtype;
    the mask's is None unless ``need_dmask``."""
    (a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin, g_bias,
     mean, inv, out) = res
    f32 = torch.float32
    sig = torch.sigmoid(ga.float())
    u = (a_lin.float() * sig).to(a_lin.dtype)
    a = u * mask.to(a_lin.dtype)[..., None]
    af = a.float()
    gam, bet, wf = gamma.float(), beta.float(), w_out.float()
    gbf = g_bias.float()
    da = torch.zeros(a.shape, dtype=f32, device=a.device)
    dw = torch.zeros(w_out.shape, dtype=f32, device=a.device)
    dgamma = torch.zeros(gamma.shape, dtype=f32, device=a.device)
    dbeta = torch.zeros(beta.shape, dtype=f32, device=a.device)
    dbo = torch.zeros(b_out.shape, dtype=f32, device=a.device)
    dgb = torch.zeros(g_bias.shape, dtype=f32, device=a.device)
    dbs, dgls = [], []
    for j0 in range(0, b_full.shape[1], j_block):
        sl = slice(j0, j0 + j_block)
        b_blk = b_full[:, sl].float()
        mean_b, inv_b = mean[:, :, sl, None], inv[:, :, sl, None]
        o = torch.einsum("bikc,bjkc->bijc", af, b_blk)
        xhat = (o - mean_b) * inv_b
        y = (xhat * gam + bet).to(a.dtype)
        s = torch.sigmoid(g_lin[:, :, sl].float() + gbf)
        gf = dout[:, :, sl].float()
        dz = gf * s
        # Output-gate cotangent from the saved output: g·z·s(1-s) = g·out·(1-s).
        dgl = gf * out[:, :, sl].float() * (1.0 - s)
        dy = torch.einsum("bijd,cd->bijc", dz, wf)
        dw += torch.einsum("bijc,bijd->cd", y.float(), dz)
        dgamma += torch.einsum("bijc,bijc->c", dy, xhat)
        dbeta += dy.sum(dim=(0, 1, 2))
        dbo += dz.sum(dim=(0, 1, 2))
        dgb += dgl.sum(dim=(0, 1, 2))
        gg = dy * gam
        do = inv_b * (gg - gg.mean(dim=-1, keepdim=True)
                      - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
        da += torch.einsum("bijc,bjkc->bikc", do, b_blk)
        dbs.append(torch.einsum("bijc,bikc->bjkc", do, af))
        dgls.append(dgl)
    db_full = torch.cat(dbs, dim=1)
    dgl = torch.cat(dgls, dim=2)
    # Input-gating adjoints (a = (a_lin * sigmoid(ga)).to(dt) * mask).
    da_m = da * mask.float()[..., None]
    da_lin = (da_m * sig).to(a_lin.dtype)
    dga = (da_m * a_lin.float() * sig * (1.0 - sig)).to(ga.dtype)
    dmask = (torch.einsum("bikc,bikc->bik", da, u.float()).to(mask.dtype)
             if need_dmask else None)
    return (da_lin, dga, dmask, db_full.to(b_full.dtype),
            dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dw.to(w_out.dtype),
            dbo.to(b_out.dtype), dgl.to(g_lin.dtype), dgb.to(g_bias.dtype))


def opm_bwd(res, dout: torch.Tensor, *, j_block: int = BWD_J_BLOCK,
            need_dmask: bool = True):
    """Recompute backward of the fused outer-product-mean from the saved
    (a, b_full, mask_a, mask_b, w, bias, out) and the cotangent ``dout``:
    per block of j the cotangent goes through the reassociated contraction,
    so the transients are (B, S, j block, C, D) half-contractions, never a
    (B, I, J, C, C) tensor. The saved output gives the mask-norm cotangent
    (sum_x ov·(g @ w^T) = sum_d (out - bias)·g). Each gradient is in its
    input's dtype; the masks' are None unless ``need_dmask``."""
    a, b_full, mask_a, mask_b, w, bias, out = res
    f32 = torch.float32
    c = a.shape[-1]
    maf = mask_a.float()
    af = a.float()
    w3 = w.reshape(c, c, w.shape[-1]).to(a.dtype).float()
    dev = a.device
    da = torch.zeros(a.shape, dtype=f32, device=dev)
    dma = torch.zeros(mask_a.shape, dtype=f32, device=dev)
    dw = torch.zeros(w.shape, dtype=f32, device=dev)
    dbias = torch.zeros(bias.shape, dtype=f32, device=dev)
    dbs, dmbs = [], []
    for j0 in range(0, b_full.shape[2], j_block):
        sl = slice(j0, j0 + j_block)
        b_blk, mb_blk = b_full[:, :, sl].float(), mask_b[:, :, sl].float()
        gf = dout[:, :, sl].float()
        denom = torch.einsum("bsi,bsj->bij", maf, mb_blk) + OPM_NORM_EPS
        u = gf / denom[..., None]
        h = torch.einsum("bsjy,xyd->bsjxd", b_blk, w3)
        da += torch.einsum("bijd,bsjxd->bsix", u, h)
        del h
        dh = torch.einsum("bsix,bijd->bsjxd", af, u)
        dbs.append(torch.einsum("bsjxd,xyd->bsjy", dh, w3))
        dw += torch.einsum("bsjy,bsjxd->xyd", b_blk, dh).reshape(c * c, -1)
        del dh
        dbias += gf.sum(dim=(0, 1, 2))
        if need_dmask:
            dnorm = -torch.einsum("bijd,bijd->bij", out[:, :, sl].float()
                                  - bias.float(), gf) / denom
            dma += torch.einsum("bij,bsj->bsi", dnorm, mb_blk)
            dmbs.append(torch.einsum("bij,bsi->bsj", dnorm, maf))
    db_full = torch.cat(dbs, dim=2)
    dmb = torch.cat(dmbs, dim=2).to(mask_b.dtype) if need_dmask else None
    return (da.to(a.dtype), db_full.to(b_full.dtype),
            dma.to(mask_a.dtype) if need_dmask else None, dmb,
            dw.to(w.dtype), dbias.to(bias.dtype))
