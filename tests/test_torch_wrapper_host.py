"""The host side of the LayerNorm (K1), gating (K2), fused softmax (K4)
and outer-product-mean (K8) wrappers, on the CPU: the kernels themselves
run only on the card (tests/test_torch_cuda.py).

Each wrapper refuses a CPU tensor before any other check, then takes the
checks that depend only on shapes, strides and dtypes from a cache keyed by
them (``_ln_checked``, ``_bsm_checked``, ``_softmax_checked``,
``_opm_checked``), so they run once per distinct key. These tests call the cached step directly on
``meta`` tensors: a layout or dtype not seen before under a shape already
seen is checked again and refused, and a refused key is never cached.
"""
import pytest
import torch

from repro_torch.kernels import fused_elementwise as fe
from repro_torch.kernels import fused_softmax as fs
from repro_torch.kernels import layer_norm as ln
from repro_torch.kernels import triangle as tri

META = "meta"
BF16, F32 = torch.bfloat16, torch.float32


def _empty(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# K1 LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,part", [
    ((1, 128, 256, 256), (32, 1, 8)),     # MSA rows
    ((1, 256, 256, 128), (16, 1, 8)),     # pair rows
    ((1, 256, 384), (16, 3, 8)),          # the structure module's single rows
    ((7, 1000), None),                    # the loop kernel
])
def test_ln_geometry_main_path(shape, part):
    x, g = _empty(shape, BF16), _empty(shape[-1:])
    ln._LN_GEOM.clear()
    geom = ln._ln_checked("f", x, g, g)
    rows = x.numel() // shape[-1]
    assert geom == (rows, shape[-1], 1, part)
    assert len(ln._LN_GEOM) == 1
    assert ln._ln_checked("f", x, g, g) is geom      # served from the cache


def test_ln_layout_and_dtype_are_checked_again():
    g = _empty((128,))
    ln._LN_GEOM.clear()
    ln._ln_checked("f", _empty((4, 6, 128), BF16), g, g)
    # The same shape, transposed in memory: a new key, checked and refused.
    x_t = _empty((4, 128, 6), BF16).transpose(1, 2)
    assert x_t.shape == (4, 6, 128)
    with pytest.raises(ValueError, match="contiguous"):
        ln._ln_checked("f", x_t, g, g)
    with pytest.raises(TypeError, match="dtype"):
        ln._ln_checked("f", _empty((4, 6, 128), torch.float16), g, g)
    # gamma in bf16, or a strided view of gamma.
    with pytest.raises(ValueError, match="gamma"):
        ln._ln_checked("f", _empty((4, 6, 128), BF16), _empty((128,), BF16), g)
    with pytest.raises(ValueError, match="beta"):
        ln._ln_checked("f", _empty((4, 6, 128), BF16), g, _empty((256,))[::2])
    assert len(ln._LN_GEOM) == 1


@pytest.mark.parametrize("shape", [(), (4, 0), (2, 40000)])
def test_ln_refuses_widths(shape):
    with pytest.raises(ValueError, match="C="):
        ln._ln_checked("f", _empty(shape, BF16), _empty(shape[-1:]),
                       _empty(shape[-1:]))


def test_ln_wrapper_refuses_cpu_tensors_before_any_check():
    x = torch.randn(4, 6)                      # gamma's width is wrong too
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_cuda(x, torch.ones(5), torch.zeros(5))


# ---------------------------------------------------------------------------
# K2 gating
# ---------------------------------------------------------------------------


def test_bsm_geometry_and_cache():
    g, v, bg = _empty((1, 128, 256, 256), BF16), _empty((1, 128, 256, 256), BF16), _empty((256,))
    fe._BSM_GEOM.clear()
    geom = fe._bsm_checked("f", g, bg, v)
    # 32768 rows of 256; 16-byte vectors over 32 threads a row, or one
    # element at a time over 32 (the call's alignment picks one).
    assert geom == (128 * 256, 256, 1, (8, 5), (1, 5))
    assert fe._bsm_checked("f", g, bg, v) is geom
    assert len(fe._BSM_GEOM) == 1


def test_bsm_layout_and_dtype_are_checked_again():
    bg = _empty((32,))
    v = _empty((8, 16, 32), BF16)
    fe._BSM_GEOM.clear()
    fe._bsm_checked("f", _empty((8, 16, 32), BF16), bg, v)
    g_t = _empty((8, 32, 16), BF16).transpose(1, 2)          # same shape
    with pytest.raises(ValueError, match="contiguous"):
        fe._bsm_checked("f", g_t, bg, v)
    with pytest.raises(ValueError, match="must match"):
        fe._bsm_checked("f", _empty((8, 16, 32), F32), bg, v)
    with pytest.raises(TypeError, match="dtype"):
        fe._bsm_checked("f", _empty((8, 16, 32), torch.float16), bg,
                        _empty((8, 16, 32), torch.float16))
    with pytest.raises(ValueError, match="bg"):
        fe._bsm_checked("f", _empty((8, 16, 32), BF16), _empty((32,), BF16), v)
    assert len(fe._BSM_GEOM) == 1


def test_bsm_wrapper_refuses_cpu_tensors_before_any_check():
    x = torch.randn(4, 6)
    with pytest.raises(ValueError, match="CUDA"):
        fe.bias_sigmoid_mul_cuda(x, torch.zeros(5), x.half())


# ---------------------------------------------------------------------------
# K4 fused softmax
# ---------------------------------------------------------------------------


def _sm(n=128, h=8, r=256, c=256, nb=1, dt=BF16, mask=True):
    return (_empty((n, h, r, c), dt), None if nb == 0 else
            _empty((nb, h, r, c), dt), _empty((n, c)) if mask else None)


@pytest.mark.parametrize("n,h,r,c,nb,vec_geom,scalar_geom", [
    # MSA row: rep 128, 32 lanes a row, runs of 8 pairs of rows.
    (128, 8, 256, 256, 1, (5, 1, 8, 8), (5, 8, 1, 8)),
    # MSA column: no bias, 16 lanes a row (two rows a warp).
    (256, 8, 128, 128, 0, (4, 1, 8, 4), (5, 4, 1, 8)),
    # Triangle at r = 384: 16 lanes of three vectors.
    (384, 4, 384, 384, 1, (4, 3, 8, 8), (5, 16, 1, 8)),
    # A block per row past 1024.
    (2, 2, 4, 3000, 2, (0, 0, 1, 1), (0, 0, 1, 1)),
])
def test_softmax_geometry_and_cache(n, h, r, c, nb, vec_geom, scalar_geom):
    """The cached geometry as the kernel reads it: rows, H*R, rep, C, dtype
    code, then (lanes a row as log2, vectors a lane, elements a vector,
    steps) with 16-byte vectors and one element at a time."""
    x, bias, mask = _sm(n, h, r, c, nb)
    fs._SOFTMAX_GEOM.clear()
    got = fs._softmax_checked("f", x, bias, mask)
    head = (n * h * r, h * r, n // nb if nb else 1, c, 1)
    assert [tuple(g) for g in got] == [head + vec_geom, head + scalar_geom]
    assert fs._softmax_checked("f", x, bias, mask) is got
    assert len(fs._SOFTMAX_GEOM) == 1


def test_softmax_layout_and_dtype_are_checked_again():
    x, bias, mask = _sm(8, 2, 16, 64, 2)
    fs._SOFTMAX_GEOM.clear()
    fs._softmax_checked("f", x, bias, mask)
    # The same shapes: x laid out (N, H, C, R) and read transposed; the bias
    # transposed; the bias in fp32; the mask in bf16 or transposed.
    x_t = _empty((8, 2, 64, 16), BF16).transpose(2, 3)
    assert x_t.shape == x.shape
    with pytest.raises(ValueError, match="contiguous"):
        fs._softmax_checked("f", x_t, bias, mask)
    with pytest.raises(ValueError, match="bias"):
        fs._softmax_checked("f", x, _empty((2, 2, 64, 16), BF16).transpose(2, 3),
                            mask)
    with pytest.raises(ValueError, match="bias"):
        fs._softmax_checked("f", x, _empty((2, 2, 16, 64)), mask)
    with pytest.raises(ValueError, match="mask"):
        fs._softmax_checked("f", x, bias, _empty((8, 64), BF16))
    with pytest.raises(ValueError, match="mask"):
        fs._softmax_checked("f", x, bias, _empty((64, 8)).t())
    with pytest.raises(ValueError, match="N % B"):
        fs._softmax_checked("f", x, _empty((3, 2, 16, 64), BF16), mask)
    with pytest.raises(TypeError, match="dtype"):
        fs._softmax_checked("f", _empty((8, 2, 16, 64), torch.float16), None,
                            mask)
    assert len(fs._SOFTMAX_GEOM) == 1
    # Without the bias or the mask: new keys, each checked and cached.
    fs._softmax_checked("f", x, None, mask)
    fs._softmax_checked("f", x, bias, None)
    assert len(fs._SOFTMAX_GEOM) == 3


@pytest.mark.parametrize("shape", [(4, 0), (2, 3, 4, 0), (1, 1, 2, 16385)])
def test_softmax_refuses_shapes(shape):
    with pytest.raises(ValueError, match="C=|N, H, R, C"):
        fs._softmax_checked("f", _empty(shape, BF16), None, None)


def test_softmax_wrapper_refuses_cpu_tensors_before_any_check():
    x = torch.randn(4, 6)                          # not 4-dim either
    with pytest.raises(ValueError, match="CUDA"):
        fs.fused_softmax_cuda(x, x, torch.zeros(3), 0.5)


# ---------------------------------------------------------------------------
# K8 outer-product-mean
# ---------------------------------------------------------------------------


def _opm(bsz=1, ns=128, ni=256, nj=256, c=32, d=128, dt=BF16):
    return (_empty((bsz, ns, ni, c), dt), _empty((bsz, ns, nj, c), dt),
            _empty((bsz, ns, ni)), _empty((bsz, ns, nj)),
            _empty((c * c, d), dt), _empty((d,)))


@pytest.mark.parametrize("bsz,ns,ni,nj,c,d", [
    (1, 128, 256, 256, 32, 128), (1, 128, 384, 384, 32, 128),
    (2, 37, 21, 19, 16, 32)])
def test_opm_geometry_and_cache(bsz, ns, ni, nj, c, d):
    args = _opm(bsz, ns, ni, nj, c, d)
    tri._OPM_GEOM.clear()
    geom = tri._opm_checked("f", *args)
    assert geom == (bsz, ns, ni, nj, c, d, 1)
    assert tri._opm_checked("f", *args) is geom
    assert len(tri._OPM_GEOM) == 1


def test_opm_layout_and_dtype_are_checked_again():
    a, b, ma, mb, w, bias = _opm(ni=24, nj=24)
    tri._OPM_GEOM.clear()
    tri._opm_checked("f", a, b, ma, mb, w, bias)
    # The same shapes: b laid out (B, S, C, J) and read transposed; w in
    # fp32; a mask in bf16; a transposed w of the right shape.
    b_t = _empty((1, 128, 32, 24), BF16).transpose(2, 3)
    assert b_t.shape == b.shape
    with pytest.raises(ValueError, match="b_full"):
        tri._opm_checked("f", a, b_t, ma, mb, w, bias)
    with pytest.raises(ValueError, match="w"):
        tri._opm_checked("f", a, b, ma, mb, _empty((1024, 128)), bias)
    with pytest.raises(ValueError, match="mask_a"):
        tri._opm_checked("f", a, b, _empty((1, 128, 24), BF16), mb, w, bias)
    with pytest.raises(ValueError, match="w"):
        tri._opm_checked("f", a, b, ma, mb,
                         _empty((128, 1024), BF16).t(), bias)
    with pytest.raises(TypeError, match="dtype"):
        tri._opm_checked("f", *(t.half() if t.dtype == BF16 else t
                                for t in (a, b, ma, mb, w, bias)))
    assert len(tri._OPM_GEOM) == 1


def test_opm_refuses_widths_and_grids():
    with pytest.raises(ValueError, match="channel widths"):
        tri._opm_checked("f", *_opm(c=64))
    with pytest.raises(ValueError, match="channel widths"):
        tri._opm_checked("f", *_opm(d=64))
    # The fp32 kernel's (J/4, I/4, B) grid; the bf16 kernel walks tiles.
    with pytest.raises(ValueError, match="grid"):
        tri._opm_checked("f", *_opm(ns=1, ni=300000, nj=8, dt=F32))
    assert tri._opm_checked("f", *_opm(ns=1, ni=300000, nj=8))[2] == 300000


def test_opm_wrapper_refuses_cpu_tensors_before_any_check():
    a = torch.randn(1, 4, 8, 64)                 # C = 64 would fail too
    with pytest.raises(ValueError, match="CUDA"):
        tri.fused_opm_cuda(a, a, torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                           torch.randn(64 * 64, 128), torch.zeros(128))
