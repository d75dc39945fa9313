"""The port's CUDA kernels on the card against their plain versions, at
small shapes, and the launch counters. Marked ``cuda``: each test skips
where no CUDA device is present. This file imports no JAX, so it also runs
on a machine without it:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.evoformer import DROPOUT_SITES
from repro_torch.exec.plan import ExecutionPlan, KernelPolicy, use_plan
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (copy_for_kernel,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.fused_elementwise import (bias_dropout_add_cuda,
                                                   bias_sigmoid_mul_cuda,
                                                   gate_partition)
from repro_torch.kernels.fused_softmax import (fused_softmax_cuda,
                                               softmax_partition,
                                               softmax_steps)
from repro_torch.kernels.layer_norm import layer_norm_cuda, ln_partition
from repro_torch.kernels.triangle import (fused_opm_cuda, fused_triangle_cuda,
                                          triangle_workspace)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(7, 100), (2, 3, 5, 128), (4, 33, 384)])
def test_layer_norm_kernel(gen, shape, dtype, tol):
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    _build.reset_launches()
    got = ops.layer_norm(x, gamma, beta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["layer_norm"] == 1
    _close(got, ref.layer_norm_ref(x, gamma, beta), tol)


# Both variants of the LayerNorm kernel: rows of 16-byte vectors in
# registers (C = 16, 128, 256, 384: 2, 16, 32 and 16 lanes a row), and the
# loop for C = 1000 (not whole vectors in bf16, too many in fp32) and
# 32768; 1001 rows is no multiple of the rows a block takes (16 to 256).
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,vector", [
    ((1001, 16), True), ((1001, 128), True), ((7, 143, 256), True),
    ((1001, 384), True), ((37, 1000), False), ((3, 32768), False)])
def test_layer_norm_kernel_variants(gen, shape, vector, dtype, tol):
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.1 + 1
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    assert (ln_partition(c, x.element_size()) is not None) == vector
    _build.reset_launches()
    got = layer_norm_cuda(x, gamma, beta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["layer_norm"] == 1
    _close(got, ref.layer_norm_ref(x, gamma, beta), tol)
    # A view 2 or 4 bytes off a 16-byte boundary takes the loop kernel.
    flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    xm = flat[1:].view(shape)
    xm.copy_(x)
    _close(layer_norm_cuda(xm, gamma, beta), ref.layer_norm_ref(x, gamma, beta), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(9, 24), (2, 3, 5, 128)])
def test_bias_sigmoid_mul_kernel(gen, shape, dtype, tol):
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    bg = torch.randn(shape[-1], generator=gen, device="cuda")
    _build.reset_launches()
    got = ops.bias_sigmoid_mul(g, bg, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bias_sigmoid_mul"] == 1
    _close(got, ref.bias_sigmoid_mul_ref(g, bg, v), tol)


def _view(gen, shape, offset, dtype, scale=1.0):
    """A contiguous view ``offset`` elements into a fresh buffer."""
    numel = 1
    for d in shape:
        numel *= d
    buf = torch.randn(numel + offset, generator=gen, device="cuda") * scale
    return buf.to(dtype)[offset:].view(shape)


# Both variants of the gating kernel in one launch: 16-byte vectors (C whole
# vectors, every pointer aligned; two a thread at C = 384 in bf16 and 256 in
# fp32) and one element at a time (C % 8 != 0 in bf16, a view off the
# vectors); z at +-100 where 2**x overflows.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,offset", [
    ((64, 256), 0), ((64, 256), 1), ((33, 12), 0), ((10, 384), 0),
    ((2, 16, 12, 32), 0), ((5, 16), 3), ((7, 1000), 2)])
def test_bias_sigmoid_mul_kernel_variants(gen, shape, offset, dtype, tol):
    c = shape[-1]
    g = _view(gen, shape, offset, dtype, 4.0)
    v = _view(gen, shape, offset, dtype)
    g.view(-1)[:2] = torch.tensor([-100.0, 100.0])
    bg = torch.randn(c, generator=gen, device="cuda")
    per_vec = 16 // g.element_size()
    aligned = (offset * g.element_size()) % 16 == 0
    vec = gate_partition(c, g.element_size(), aligned)[0]
    assert vec == (per_vec if aligned and c % per_vec == 0 else 1)
    _build.reset_launches()
    got = bias_sigmoid_mul_cuda(g, bg, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bias_sigmoid_mul"] == 1
    _close(got, ref.bias_sigmoid_mul_ref(g, bg, v), tol)


# (N, Sq, Skv, H, D, B, bias, mask, G): G None takes the wrapper's choice.
FLASH_CASES = [
    (6, 40, 40, 2, 32, 2, True, True, None),      # rep 3
    (3, 20, 70, 2, 16, 1, True, True, None),      # ragged last KV tile
    (2, 130, 130, 1, 32, 1, False, False, None),  # ragged q tile, no bias/mask
    (4, 12, 12, 2, 16, 4, False, True, None),
    (16, 100, 70, 2, 32, 1, True, True, 4),       # rep 16 > G 4; Sq, Skv ragged
    (4, 5, 9, 2, 32, 2, True, True, 2),           # Sq < 16
    (3, 33, 45, 2, 32, 3, True, True, None),      # rep 1
    (8, 70, 130, 2, 16, 2, True, True, 4),        # D 16 with G 4
    (2, 20, 600, 1, 32, 1, True, True, None),     # bias slice too wide to stage
    # The streamed bias (Skv padded past 384), at the wrapper's G:
    (64, 64, 2048, 32, 16, 1, True, True, None),  # Skv 2048, rep = N (G 2)
    (3, 20, 450, 2, 32, 1, True, True, None),     # ragged, Skv % 8 != 0: elements
    (1, 600, 600, 2, 32, 1, True, True, None),    # Sq 600, rep 1
    (2, 70, 520, 2, 16, 1, True, False, None),    # bias without mask
]


def _flash_inputs(gen, n, sq, skv, h, d, nb, bias, mask, dtype):
    qkv = torch.randn((n, max(sq, skv), 3 * h * d), generator=gen,
                      device="cuda").to(dtype)
    q = qkv[:, :sq, :h * d].unflatten(-1, (h, d))          # strided views
    k = qkv[:, :skv, h * d:2 * h * d].unflatten(-1, (h, d))
    v = qkv[:, :skv, 2 * h * d:].unflatten(-1, (h, d))
    b = (torch.randn((nb, h, sq, skv), generator=gen, device="cuda").to(dtype)
         if bias else None)
    m = None
    if mask:
        keep = torch.rand((n, skv), generator=gen, device="cuda") < 0.8
        keep[0] = False                     # one fully masked row
        m = torch.where(keep, 0.0, -1e9).float()
    return q, k, v, b, m


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,sq,skv,h,d,nb,bias,mask,groups", FLASH_CASES)
def test_flash_attention_kernel(gen, n, sq, skv, h, d, nb, bias, mask, groups,
                                dtype, tol):
    q, k, v, b, m = _flash_inputs(gen, n, sq, skv, h, d, nb, bias, mask, dtype)
    _build.reset_launches()
    out, lse = flash_attention_cuda(q, k, v, b, m, d ** -0.5, groups)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd"] == 1
    # The bf16 kernel streams a bias wider than 384 keys, and counts it.
    streamed = dtype == torch.bfloat16 and bias and skv > 384
    assert _build.LAUNCHES["flash_attention_fwd.streamed_bias"] == streamed
    want, want_lse = ref.attention_ref(q, k, v, b, m, d ** -0.5)
    _close(out, want, tol)
    _close(lse, want_lse, 1e-4)


@pytest.mark.parametrize("n,sq,skv,nb,mask", [
    (8, 130, 2048, 1, True),      # rep = N
    (8, 40, 450, 2, True),        # rep 4, Skv % 8 != 0: element copies
    (4, 64, 520, 1, False),       # no mask
])
def test_flash_attention_streamed_groups_agree(gen, n, sq, skv, nb, mask):
    """The streamed bias path at G 1 and 2 (groups side by side over one
    bias tile) gives the same bits: a row's arithmetic does not depend on
    which groups share its block."""
    q, k, v, b, m = _flash_inputs(gen, n, sq, skv, 2, 32, nb, True, mask,
                                  torch.bfloat16)
    _build.reset_launches()
    runs = [flash_attention_cuda(q, k, v, b, m, 0.2, g) for g in (1, 2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd.streamed_bias"] == 2
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])
    want, _ = ref.attention_ref(q, k, v, b, m, 0.2)
    _close(runs[0][0], want, 2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,sq,skv,h,d,nb,bias,mask,groups", FLASH_CASES + [
    (2, 600, 40, 1, 32, 1, True, True, None),     # dk/dv slice too wide
])
def test_flash_attention_bwd_kernel(gen, n, sq, skv, h, d, nb, bias, mask,
                                    groups, dtype, tol):
    """The backward against attention_bwd_ref on the forward kernel's own
    (out, lse), q/k/v as strided views, a fully masked row, the mask's
    gradient asked for."""
    q, k, v, b, m = _flash_inputs(gen, n, sq, skv, h, d, nb, bias, mask, dtype)
    scale = d ** -0.5
    out, lse = flash_attention_cuda(q, k, v, b, m, scale)
    do = torch.randn((n, sq, h, d), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, b, m, scale,
                                   need_dmask=True, groups=groups)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.attention_bwd_ref(q, k, v, do, out, lse, b, m, scale)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            _close(g, w, tol)


@pytest.mark.parametrize("groups", [None, 1, 4])
def test_flash_attention_bwd_kernel_is_deterministic(gen, groups):
    """Two bf16 backward runs on the same inputs give the same bits: no
    floating-point atomics, every sum in a fixed order."""
    q, k, v, b, m = _flash_inputs(gen, 16, 100, 130, 2, 32, 2, True, True,
                                  torch.bfloat16)
    out, lse = flash_attention_cuda(q, k, v, b, m, 0.2)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    runs = [flash_attention_bwd_cuda(q, k, v, out, do, lse, b, m, 0.2,
                                     need_dmask=True, groups=groups)
            for _ in range(2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_flash_attention_copies_misaligned_views(gen):
    """bf16 views whose data pointer or N/S stride is not a multiple of 16
    bytes are copied by the wrappers (copy_for_kernel), then run the
    kernels, with the plain version's results."""
    n, s, h, d = 4, 40, 2, 32
    buf = torch.randn(n * s * (3 * h * d + 2) + 8, generator=gen,
                      device="cuda").to(torch.bfloat16)
    stride = (s * (3 * h * d + 2), 3 * h * d + 2, d, 1)   # S stride 194
    q, k, v = (buf[1 + i * h * d:].as_strided((n, s, h, d), stride)
               for i in range(3))
    assert all(copy_for_kernel(t) for t in (q, k, v))
    b = torch.randn((2, h, s, s), generator=gen, device="cuda").to(torch.bfloat16)
    _build.reset_launches()
    out, lse = flash_attention_cuda(q, k, v, b, None, 0.2)
    want, want_lse = ref.attention_ref(q, k, v, b, None, 0.2)
    _close(out, want, 2e-2)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, b, None, 0.2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd"] == 1
    assert _build.LAUNCHES["flash_attention_bwd"] == 1
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, do, out, lse, b, None,
                                               0.2)):
        if w is not None:
            _close(g, w, 2e-2)


# (case, x shape, keep shape): a small shape with the shared axis 1 or 2,
# then the six dropout sites of the FULL-width main path (DROPOUT_SITES:
# the MSA row at (1, s, r, 256), the pair sites at (1, r, r, 128), s = 128,
# r = 256), each with its reduced mask.
_FULL_MSA, _FULL_PAIR = (1, 128, 256, 256), (1, 256, 256, 128)
BDA_CASES = [("small_axis1", (1, 12, 20, 128), (1, 1, 20, 128)),
             ("small_axis2", (1, 12, 20, 128), (1, 12, 1, 128))] + [
    (site, _FULL_MSA if site == "msa_row" else _FULL_PAIR,
     tuple(1 if i == axis else n for i, n in enumerate(
         _FULL_MSA if site == "msa_row" else _FULL_PAIR)))
    for site, axis in DROPOUT_SITES.items()]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case,shape,keep_shape", BDA_CASES,
                         ids=[c[0] for c in BDA_CASES])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("keep_dtype", [torch.float32, torch.uint8,
                                        torch.bool])
def test_bias_dropout_add_kernel(gen, with_bias, case, shape, keep_shape,
                                 keep_dtype, dtype, tol):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    res = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(shape[-1], generator=gen, device="cuda") if with_bias
         else None)
    keep = (torch.rand(keep_shape, generator=gen, device="cuda") < 0.75)
    keep = keep.to(keep_dtype)
    _build.reset_launches()
    got = ops.bias_dropout_add(x, b, res, 0.25, keep)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bias_dropout_add"] == 1
    _close(got, ref.bias_dropout_add_ref(x, b, res, keep, 0.25), tol)
    if b is not None:
        _build.reset_launches()
        got = ops.bias_dropout_add(x, b, res)        # bias, no dropout
        assert _build.LAUNCHES["bias_dropout_add"] == 1
        _close(got, ref.bias_dropout_add_ref(x, b, res, None, 0.0), tol)


def test_autograd_backward_launches_the_attention_backward(gen):
    q = torch.randn((2, 40, 2, 32), generator=gen, device="cuda",
                    requires_grad=True)
    bias = torch.randn((1, 2, 40, 40), generator=gen, device="cuda",
                       requires_grad=True)
    _build.reset_launches()
    ops.fused_attention(q, q, q, bias=bias).square().sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd"] == 1
    assert _build.LAUNCHES["flash_attention_bwd"] == 1
    assert q.grad.shape == q.shape and bias.grad.shape == bias.shape


def test_kernel_wrappers_raise_on_what_they_do_not_take(gen):
    x = torch.randn((4, 8), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        ops.layer_norm(x, torch.ones(8, device="cuda"),
                       torch.zeros(9, device="cuda"))
    q = torch.randn((2, 5, 1, 24), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q, None, None, 1.0)
    with pytest.raises(TypeError):
        ops.bias_sigmoid_mul(x.half(), torch.zeros(8, device="cuda"), x.half())
    lse = torch.zeros((2, 1, 5), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd_cuda(q, q, q, q, q, lse, None, None, 1.0)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(*(t.half() for t in (q, q, q, q, q)), lse,
                                 None, None, 1.0)
    with pytest.raises(TypeError):
        bias_dropout_add_cuda(x.half(), None, x.half(), None, 0.0)
    with pytest.raises(ValueError, match="C % 8"):
        bias_dropout_add_cuda(x[:, :6].contiguous(), None,
                              x[:, :6].contiguous(), None, 0.0)
    with pytest.raises(ValueError, match="broadcast"):
        bias_dropout_add_cuda(x, None, x, torch.ones((3, 1), device="cuda"),
                              0.25)


def _randn(gen, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bsz,ni,nj,nk,c,d,incoming", [
    (1, 40, 40, 40, 128, 128, False),   # FULL widths, ragged against the 16 tile
    (2, 19, 33, 21, 32, 32, False),     # MINI widths, I != J
    (1, 16, 16, 70, 32, 128, False),    # C != D
    (1, 17, 130, 200, 128, 128, False), # I, J, K all off the tiles
    (2, 48, 40, 36, 128, 128, True),    # B = 2, the incoming update's views
    (1, 64, 64, 16, 128, 128, False),   # I J C fp32 well above the workspace
])
def test_triangle_mult_kernel(gen, bsz, ni, nj, nk, c, d, incoming, dtype,
                              tol):
    # a_lin and ga are column halves of one merged projection, as in the
    # Evoformer: (B, I, K, 2C), or for the incoming update (B, K, I, 2C)
    # read transposed; the mask is a transposed view with two fully masked
    # rows.
    proj = (bsz, nk, ni, 2 * c) if incoming else (bsz, ni, nk, 2 * c)
    ab = _randn(gen, proj, 1.0, dtype)
    g = _randn(gen, proj, 2.0, dtype)
    if incoming:
        ab, g = ab.transpose(1, 2), g.transpose(1, 2)
    keep = torch.rand((bsz, nk, ni), generator=gen, device="cuda") < 0.8
    mask = keep.float().transpose(1, 2)
    mask[:, :2] = 0.0
    args = (ab[..., :c], g[..., :c], mask, _randn(gen, (bsz, nj, nk, c), 1.0, dtype),
            1 + _randn(gen, (c,), 0.1), _randn(gen, (c,), 0.1),
            _randn(gen, (c, d), c ** -0.5), _randn(gen, (d,), 0.1),
            _randn(gen, (bsz, ni, nj, d), 2.0, dtype), _randn(gen, (d,)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launches()
    out, mean, inv = fused_triangle_cuda(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert _build.LAUNCHES["triangle_mult"] == 1
    # Nothing beyond the outputs and the bf16 workspace (each allocation
    # rounded up to the allocator's 512 bytes): no (B, I, J, C) product.
    ws = (triangle_workspace(bsz, ni, nj, nk, c, d)["numel"] * 2
          if dtype == torch.bfloat16 else 0)
    allowed = (out.numel() * out.element_size() + 2 * mean.numel() * 4 + ws
               + 4 * 512)
    assert peak <= allowed, (peak, allowed)
    if (ni, nj, nk) == (64, 64, 16) and dtype == torch.bfloat16:
        assert allowed < bsz * ni * nj * c * 4      # the check can see one
    want, want_mean, want_inv = ref.triangle_mult_ref(*args)
    _close(out, want, tol)
    _close(mean, want_mean, tol)     # fp32 sums of operands in the dtype
    _close(inv, want_inv, tol)
    # A fully masked a row: LN of zeros, (0 - 0) * rsqrt(eps).
    assert float(mean[:, :2].abs().max()) == 0.0
    _close(inv[:, :2], torch.full_like(inv[:, :2], 1e-5 ** -0.5), 1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bsz,ns,ni,nj,c,d", [
    (1, 40, 20, 20, 32, 128),     # FULL widths, ragged S, I and J
    (2, 33, 35, 17, 16, 32),      # MINI widths
])
def test_outer_product_mean_kernel(gen, bsz, ns, ni, nj, c, d, dtype, tol):
    mask = (torch.rand((bsz, ns, ni), generator=gen, device="cuda") < 0.8).float()
    mask[:, 1] = 0.0                         # a fully masked MSA row
    mask[..., 3] = 0.0                       # a residue masked in every row
    mask_b = mask[..., :nj].contiguous()     # nj <= ni in every case
    a = _randn(gen, (bsz, ns, ni, c), 1.0, dtype) * mask[..., None].to(dtype)
    b = (_randn(gen, (bsz, ns, nj, c), 1.0, dtype)
         * mask_b[..., None].to(dtype))
    w = _randn(gen, (c * c, d), 1.0 / c, dtype)
    bias = _randn(gen, (d,))
    _build.reset_launches()
    out = fused_opm_cuda(a, b, mask, mask_b, w, bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["outer_product_mean"] == 1
    _close(out, ref.outer_product_mean_ref(a, b, mask, mask_b, w, bias), tol)
    _close(out[:, 3], bias.to(dtype).expand_as(out[:, 3]), 0.0)


# The bf16 kernel on wgmma at the main path's calls (FULL widths, r = 256
# and 384) and off them: B = 2, I and J off the 8-pixel tile, S off the
# 32-row stage and below it, the MINI widths and C != D pairs.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bsz,ns,ni,nj,c,d", [
    (1, 128, 256, 256, 32, 128),
    (1, 128, 384, 384, 32, 128),
    (2, 37, 21, 19, 32, 128),
    (2, 40, 30, 26, 16, 32),
    (1, 8, 20, 20, 16, 128),
    (1, 70, 17, 40, 32, 32),
])
def test_outer_product_mean_kernel_main_path(gen, bsz, ns, ni, nj, c, d, dtype,
                                             tol):
    nr = max(ni, nj)
    mask = (torch.rand((bsz, ns, nr), generator=gen, device="cuda") < 0.9).float()
    mask[:, 2] = 0.0                         # a fully masked MSA row
    mask[..., 5] = 0.0                       # a residue masked in every row
    mask_a, mask_b = mask[..., :ni].contiguous(), mask[..., :nj].contiguous()
    a = _randn(gen, (bsz, ns, ni, c), 1.0, dtype) * mask_a[..., None].to(dtype)
    b = _randn(gen, (bsz, ns, nj, c), 1.0, dtype) * mask_b[..., None].to(dtype)
    w = _randn(gen, (c * c, d), 1.0 / c, dtype)
    bias = _randn(gen, (d,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launches()
    out = fused_opm_cuda(a, b, mask_a, mask_b, w, bias)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert _build.LAUNCHES["outer_product_mean"] == 1
    # Nothing beyond the output (rounded up to the allocator's 512 bytes).
    assert peak <= out.numel() * out.element_size() + 512, peak
    _close(out, ref.outer_product_mean_ref(a, b, mask_a, mask_b, w, bias), tol)
    _close(out[:, 5], bias.to(dtype).expand_as(out[:, 5]), 0.0)
    _close(out[:, :, 5], bias.to(dtype).expand_as(out[:, :, 5]), 0.0)


def test_outer_product_mean_refuses_misaligned_bf16(gen):
    flat = torch.zeros(8 * 9 * 32 + 8, dtype=torch.bfloat16, device="cuda")
    am = flat[1:1 + 8 * 9 * 32].view(1, 8, 9, 32)    # 2 bytes off 16
    ones = torch.ones((1, 8, 9), device="cuda")
    w = _randn(gen, (32 * 32, 128), 1.0 / 32, torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fused_opm_cuda(am, am, ones, ones, w, torch.zeros(128, device="cuda"))


def test_triangle_and_opm_refuse_other_widths(gen):
    x = _randn(gen, (1, 8, 8, 64))
    with pytest.raises(ValueError, match="channel widths"):
        fused_triangle_cuda(x, x, torch.ones((1, 8, 8), device="cuda"), x,
                            torch.ones(64, device="cuda"),
                            torch.zeros(64, device="cuda"),
                            _randn(gen, (64, 64)), torch.zeros(64, device="cuda"),
                            x, torch.zeros(64, device="cuda"))
    a = _randn(gen, (1, 4, 8, 64))
    with pytest.raises(ValueError, match="channel widths"):
        fused_opm_cuda(a, a, torch.ones((1, 4, 8), device="cuda"),
                       torch.ones((1, 4, 8), device="cuda"),
                       _randn(gen, (64 * 64, 128)), torch.zeros(128, device="cuda"))


def _softmax_err(got, want, tol):
    """Max over the elements that are not NaN in ``want`` of |got - want| /
    max(|want|, SOFTMAX_ATOL / tol): held to ``tol`` this is |got - want| <=
    max(tol * |want|, SOFTMAX_ATOL), each element against its own value (a
    softmax output is ~1/C, far below a limit relative to max(1, .))."""
    nan = torch.isnan(want)
    g = got.float().masked_fill(nan, 0)
    w = want.float().masked_fill(nan, 0)
    return ((g - w).abs() / w.abs().clamp_min(SOFTMAX_ATOL / tol)).max().item()


# One rounding of the output: a bf16 ulp is at most 2**-7 of the value,
# an fp32 sum in another order a few fp32 ulps; below SOFTMAX_ATOL an
# element is held absolutely.
SOFTMAX_ATOL = 1e-9


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("n,h,r,c,nb,bias,mask", [
    (6, 2, 5, 256, 2, True, True),       # rep 3, warp path, 16-byte loads
    (4, 2, 3, 200, 4, True, True),       # rep 1, ragged against the warp
    (3, 1, 4, 33, 1, True, False),       # odd C: scalar loads
    (2, 2, 3, 1, 1, False, True),        # C = 1
    (2, 1, 2, 3000, 1, True, True),      # block per row
    (1, 1, 2, 16384, 1, False, False),   # the envelope's edge
])
def test_fused_softmax_kernel(gen, n, h, r, c, nb, bias, mask, dtype, tol):
    """K4 against softmax_ref, element by element, with one row masked by
    -1e9 (near-uniform) and one by -inf (NaN, as in the reference); the
    same limit rejects the plain version with the mask or the bias left out,
    or with the -1e9 row written as 0."""
    x = (torch.randn((n, h, r, c), generator=gen, device="cuda") * 2).to(dtype)
    b = (torch.randn((nb, h, r, c), generator=gen, device="cuda").to(dtype)
         if bias else None)
    m = None
    if mask:
        keep = torch.rand((n, c), generator=gen, device="cuda") < 0.8
        m = torch.where(keep, 0.0, -1e9).float()
        m[0] = -1e9
        m[-1] = float("-inf")
    _build.reset_launches()
    got = fused_softmax_cuda(x, b, m, 0.3)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_softmax"] == 1
    assert got.dtype == dtype
    want = ref.softmax_ref(x, b, m, 0.3)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert _softmax_err(got, want, tol) <= tol
    controls = [ref.softmax_ref(x, b, None, 0.3) if mask else None,
                ref.softmax_ref(x, None, m, 0.3) if bias else None]
    if mask and c > 1:
        controls.append(want.clone())
        controls[-1][0] = 0
    nan = torch.isnan(want)
    for bad in controls:
        if bad is not None and not torch.equal(bad.masked_fill(nan, 0),
                                               want.masked_fill(nan, 0)):
            assert _softmax_err(bad, want, tol) > tol


# The rows kernel's runs: H*R odd (15, 7, 31, 1311), no multiple of a run,
# so runs cross from one n into the next (and with it the mask row and the
# bias batch); C = 128, two rows a warp (bf16); C = 384, 16 lanes of three
# vectors (bf16); an n
# whose mask row is all -inf inside a run beside n that are not; more than
# one step a warp (68172 rows); a view off the 16-byte vectors (one element
# at a time).
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("n,h,r,c,nb,inf_n,offset", [
    (7, 3, 5, 128, 7, 3, 0),
    (9, 1, 7, 128, 3, 4, 0),
    (6, 1, 31, 384, 2, 2, 0),
    (52, 3, 437, 256, 4, 17, 0),
    (5, 3, 5, 256, 5, 2, 1),
])
def test_fused_softmax_kernel_runs(gen, n, h, r, c, nb, inf_n, offset, dtype,
                                   tol):
    x = _view(gen, (n, h, r, c), offset, dtype, 4.0)
    b = (torch.randn((nb, h, r, c), generator=gen, device="cuda") * 2).to(dtype)
    keep = torch.rand((n, c), generator=gen, device="cuda") < 0.8
    m = torch.where(keep, 0.0, -1e9).float()
    m[0] = -1e9
    m[inf_n] = float("-inf")
    aligned = (offset * x.element_size()) % 16 == 0
    part = softmax_partition(c, x.element_size(), aligned)
    assert (part[2] > 1) == aligned
    if offset == 0:
        rows, lanes = n * h * r, part[0]
        run = softmax_steps(rows, lanes) * 2 * (32 // lanes)
        assert (h * r) % run != 0
    _build.reset_launches()
    got = fused_softmax_cuda(x, b, m, 0.3)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_softmax"] == 1
    want = ref.softmax_ref(x, b, m, 0.3)
    nan = torch.isnan(want)
    assert nan[inf_n].all() and nan.sum() == h * r * c
    assert torch.equal(torch.isnan(got), nan)
    assert _softmax_err(got, want, tol) <= tol
    for bad in (ref.softmax_ref(x, b, None, 0.3),
                ref.softmax_ref(x, None, m, 0.3)):
        assert _softmax_err(bad, want, tol) > tol


def test_attention_oracle_runs_the_softmax_kernel_with_autograd(gen):
    """Under KernelPolicy(attention="oracle") the 5D softmax flattens onto
    K4, and its backward is the reference's VJP: the gradients match
    autograd of the plain version."""
    x = torch.randn((2, 3, 2, 40, 40), generator=gen, device="cuda",
                    requires_grad=True)
    bias = torch.randn((2, 2, 40, 40), generator=gen, device="cuda",
                       requires_grad=True)
    mask = torch.where(torch.rand((2, 3, 40), generator=gen, device="cuda")
                       < 0.8, 0.0, -1e9)
    plan = ExecutionPlan(kernels=KernelPolicy(attention="oracle"))
    _build.reset_launches()
    with use_plan(plan):
        y = ops.fused_softmax(x, bias=bias, mask=mask, scale=0.25)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_softmax"] == 1
    got = (x.grad, bias.grad)
    x.grad = bias.grad = None
    with use_plan(ExecutionPlan(kernels=KernelPolicy(softmax="xla"))):
        want_y = ops.fused_softmax(x, bias=bias, mask=mask, scale=0.25)
    want_y.square().sum().backward()
    assert _build.LAUNCHES["fused_softmax"] == 1       # the plain version
    _close(y, want_y, 1e-5)
    for g, w in zip(got, (x.grad, bias.grad)):
        _close(g, w, 1e-5)


def test_oracle_plan_launches_nothing(gen):
    x = torch.randn((4, 8), generator=gen, device="cuda")
    _build.reset_launches()
    with use_plan(ExecutionPlan(kernels=KernelPolicy(enabled=False))):
        ops.layer_norm(x, torch.ones(8, device="cuda"),
                       torch.zeros(8, device="cuda"))
        ops.fused_softmax(x.view(1, 1, 4, 8))
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# AutoChunk's knobs on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kv_tile", [64, 128])
def test_flash_attention_takes_and_ignores_kv_tile(gen, kv_tile, dtype, tol):
    """K5's wrapper accepts AutoChunk's KV tile and launches the same
    kernel on the same numbers; the plain version takes that many query
    rows at a time, on the same numbers."""
    q, k, v, b, m = _flash_inputs(gen, 6, 200, 200, 2, 32, 2, True, True,
                                  dtype)
    _build.reset_launches()
    out, lse = flash_attention_cuda(q, k, v, b, m, 32 ** -0.5,
                                    kv_tile=kv_tile)
    base, base_lse = flash_attention_cuda(q, k, v, b, m, 32 ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd"] == 2
    assert torch.equal(out, base) and torch.equal(lse, base_lse)
    want, want_lse = ref.attention_ref(q, k, v, b, m, 32 ** -0.5,
                                       kv_tile=kv_tile)
    whole, whole_lse = ref.attention_ref(q, k, v, b, m, 32 ** -0.5)
    _close(want, whole, 1e-6)
    _close(want_lse, whole_lse, 1e-6)
    _close(out, want, tol)
    got = ops.fused_attention(q, k, v, bias=b, mask=m, kv_tile=kv_tile)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tile", [16, 64])
def test_triangle_and_opm_take_and_ignore_their_tile(gen, tile, dtype, tol):
    """K7's and K8's wrappers accept AutoChunk's tile and launch the same
    kernel on the same numbers; the plain versions take j blocks of the
    tile, on the same numbers."""
    c = d = 128
    ab = _randn(gen, (1, 70, 50, 2 * c), 1.0, dtype)
    g = _randn(gen, (1, 70, 50, 2 * c), 2.0, dtype)
    mask = (torch.rand((1, 70, 50), generator=gen, device="cuda")
            < 0.8).float()
    args = (ab[..., :c], g[..., :c], mask, _randn(gen, (1, 90, 50, c), 1.0, dtype),
            1 + _randn(gen, (c,), 0.1), _randn(gen, (c,), 0.1),
            _randn(gen, (c, d), c ** -0.5), _randn(gen, (d,), 0.1),
            _randn(gen, (1, 70, 90, d), 2.0, dtype), _randn(gen, (d,)))
    _build.reset_launches()
    out = fused_triangle_cuda(*args, tile=tile)
    base = fused_triangle_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["triangle_mult"] == 2
    assert all(torch.equal(x, y) for x, y in zip(out, base))
    # The plain version in j blocks: the same sums, rounded once to the
    # dtype (in bf16 a product of another M may round to the next value).
    want = ref.triangle_mult_ref(*args, tile=tile)
    for x, y in zip(want, ref.triangle_mult_ref(*args)):
        _close(x, y, tol)
    _close(out[0], want[0], tol)
    _close(ops.fused_triangle_mult(*args, tile=tile), want[0], tol)

    oc, ns = 32, 40
    omask = (torch.rand((1, ns, 70), generator=gen, device="cuda")
             < 0.8).float()
    a = _randn(gen, (1, ns, 70, oc), 1.0, dtype) * omask[..., None].to(dtype)
    b = _randn(gen, (1, ns, 70, oc), 1.0, dtype) * omask[..., None].to(dtype)
    w, bias = _randn(gen, (oc * oc, d), 1.0 / oc, dtype), _randn(gen, (d,))
    _build.reset_launches()
    out = fused_opm_cuda(a, b, omask, omask, w, bias, tile=tile)
    assert torch.equal(out, fused_opm_cuda(a, b, omask, omask, w, bias))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["outer_product_mean"] == 2
    want = ref.outer_product_mean_ref(a, b, omask, omask, w, bias, tile=tile)
    _close(want, ref.outer_product_mean_ref(a, b, omask, omask, w, bias),
           tol)
    _close(out, want, tol)
    _close(ops.fused_outer_product_mean(a, b, omask, omask, w, bias,
                                        tile=tile), want, tol)


@pytest.mark.parametrize("kernels", ["default", "attention-oracle"])
@pytest.mark.parametrize("knobs", [
    {"inference_chunk": 16},
    {"inference_chunk": 8, "opm_chunk": 16, "attn_kv_tile": 128,
     "tri_k_tile": 16, "opm_s_tile": 16}])
def test_chunked_fold_matches_unchunked(gen, knobs, kernels):
    """A MINI-width fold on the card (its widths take K5, K7 and K8), r =
    64, s = 16, bf16, with forced chunk knobs against the same fold with
    none: within the bf16 module tolerance, and the attention kernel (K5,
    or K4 under attention-oracle) and the output gate launched once per
    chunk at every site."""
    import dataclasses

    from repro_torch.configs import MINI
    from repro_torch.data import protein_batches
    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import MemoryPolicy

    cfg = dataclasses.replace(MINI, n_recycle=0)
    kern = (KernelPolicy(attention="oracle") if kernels == "attention-oracle"
            else KernelPolicy())
    s, r = 16, 64
    batch = next(protein_batches(batch=1, n_seq=s, n_res=r, seed=3,
                                 n_real=57)).as_dict()
    ff = FastFold(cfg)
    params = ff.init(seed=1)
    outs, counts = {}, {}
    for name, mem in (("none", MemoryPolicy(auto_chunk=False)),
                      ("knobs", MemoryPolicy(**knobs))):
        _build.reset_launches()
        outs[name] = ff.forward(params, batch, plan=ExecutionPlan(
            kernels=kern, memory=mem))
        torch.cuda.synchronize()
        counts[name] = dict(_build.LAUNCHES)
    for k in ("coords", "msa_logits", "distogram_logits", "pair"):
        _close(outs["knobs"][k], outs["none"][k], 2e-2)
    ic = knobs["inference_chunk"]
    chunks = s // ic + 3 * (r // ic)          # MSA row, MSA col, 2 triangle
    nb = cfg.evoformer.n_blocks
    attn = "fused_softmax" if kernels == "attention-oracle" \
        else "flash_attention_fwd"
    assert counts["none"][attn] == 4 * nb
    assert counts["knobs"][attn] == chunks * nb
    assert (counts["knobs"]["bias_sigmoid_mul"]
            - counts["none"]["bias_sigmoid_mul"]) == (chunks - 4) * nb
    for k in ("triangle_mult", "outer_product_mean", "layer_norm"):
        assert counts["knobs"][k] == counts["none"][k]


def test_card_budget_is_the_cards_memory_less_what_is_allocated(gen):
    from repro_torch.device import hbm_budget_bytes

    total = torch.cuda.get_device_properties(0).total_memory
    x = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    assert hbm_budget_bytes("cuda") == total - torch.cuda.memory_allocated()
    assert hbm_budget_bytes("cuda") <= total - x.numel()


# The shapes Dynamic Axial Parallelism over two ranks gives the triangle
# update and the outer-product-mean at r = 256, s = 128 (FULL widths): each
# rank's I = 128 rows against the gathered J = K = 256 (the incoming update
# on the transposed pair's layout), and the OPM's I = 128 columns against
# J = 256. Forward on the kernel and the backward through the op's
# autograd, against the plain version (the "oracle" leg) on the same card.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("incoming", [False, True])
def test_triangle_mult_at_dap_shard_shapes(gen, incoming, dtype, tol):
    bsz, ni, nj, nk, c, d = 1, 128, 256, 256, 128, 128
    proj = (bsz, nk, ni, 2 * c) if incoming else (bsz, ni, nk, 2 * c)
    ab = _randn(gen, proj, 1.0, dtype)
    g = _randn(gen, proj, 2.0, dtype)
    mask = (torch.rand(proj[:3], generator=gen, device="cuda") < 0.9).float()
    if incoming:
        ab, g, mask = ab.transpose(1, 2), g.transpose(1, 2), mask.transpose(1, 2)
    leaves = [ab[..., :c], g[..., :c], mask,
              _randn(gen, (bsz, nj, nk, c), 1.0, dtype),
              1 + _randn(gen, (c,), 0.1), _randn(gen, (c,), 0.1),
              _randn(gen, (c, d), c ** -0.5), _randn(gen, (d,), 0.1),
              _randn(gen, (bsz, ni, nj, d), 2.0, dtype), _randn(gen, (d,))]
    outs = {}
    for leg in ("auto", "oracle"):
        args = [t.detach().clone().requires_grad_(i != 2)
                for i, t in enumerate(leaves)]
        _build.reset_launches()
        with use_plan(ExecutionPlan(kernels=KernelPolicy(triangle=leg))):
            out = ops.fused_triangle_mult(*args)
            out.float().sin().sum().backward()
        torch.cuda.synchronize()
        assert _build.LAUNCHES["triangle_mult"] == (leg == "auto")
        outs[leg] = [out] + [a.grad for i, a in enumerate(args) if i != 2]
    for got, want in zip(outs["auto"], outs["oracle"]):
        _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_outer_product_mean_at_dap_shard_shapes(gen, dtype, tol):
    bsz, ns, ni, nj, c, d = 1, 128, 128, 256, 32, 128
    mask_b = (torch.rand((bsz, ns, nj), generator=gen, device="cuda")
              < 0.9).float()
    mask_a = mask_b[..., :ni].contiguous()
    leaves = [_randn(gen, (bsz, ns, ni, c), 1.0, dtype)
              * mask_a[..., None].to(dtype),
              _randn(gen, (bsz, ns, nj, c), 1.0, dtype)
              * mask_b[..., None].to(dtype),
              _randn(gen, (c * c, d), 1.0 / c, dtype), _randn(gen, (d,))]
    outs = {}
    for leg in ("auto", "oracle"):
        a, b, w, bias = [t.detach().clone().requires_grad_(True)
                         for t in leaves]
        _build.reset_launches()
        with use_plan(ExecutionPlan(kernels=KernelPolicy(opm=leg))):
            out = ops.fused_outer_product_mean(a, b, mask_a, mask_b, w, bias)
            out.float().sin().sum().backward()
        torch.cuda.synchronize()
        assert _build.LAUNCHES["outer_product_mean"] == (leg == "auto")
        outs[leg] = [out, a.grad, b.grad, w.grad, bias.grad]
    for got, want in zip(outs["auto"], outs["oracle"]):
        _close(got, want, tol)


def test_process_group_backend_on_one_nccl_rank_is_local_dist(gen, tmp_path):
    """One FULL-width Evoformer block (r = 64, s = 32, bf16, dropout,
    checkpointed) on a world-size-1 NCCL group: its outputs and every
    gradient equal to ``LocalDist``'s to the bit (the same products and
    kernels; the collectives and the trigger/block pair move the bytes
    unchanged)."""
    import dataclasses

    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.core.alphafold import draw_dropout_keeps
    from repro_torch.core.evoformer import evoformer_stack, init_evoformer_stack
    from repro_torch.layers.params import tree_leaves, tree_map

    evo = FULL.evoformer
    cpu = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: (0.05 * torch.randn(t.shape, generator=cpu))
                      .to("cuda"), init_evoformer_stack(cpu, evo)[:1])
    b, s, r = 1, 32, 64
    msa = _randn(gen, (b, s, r, evo.d_msa), 1.0, torch.bfloat16)
    pair = _randn(gen, (b, r, r, evo.d_pair), 1.0, torch.bfloat16)
    masks = (torch.ones(b, s, r, device="cuda"), torch.ones(b, r, device="cuda"),
             torch.ones(b, r, r, device="cuda"))
    keeps = draw_dropout_keeps(dataclasses.replace(FULL, evoformer=(
        dataclasses.replace(evo, n_blocks=1))), (b, s, r), gen)

    def run(dist):
        live = tree_map(lambda t: t.clone().requires_grad_(True), params)
        m_in, z_in = msa.clone().requires_grad_(True), pair.clone().requires_grad_(True)
        m, z = evoformer_stack(live, m_in, z_in, *masks, cfg=evo, keeps=keeps,
                               remat=True, dist=dist)
        (m.float().sin().sum() + z.float().sin().sum()).backward()
        return [m, z, m_in.grad, z_in.grad] + [t.grad for t in tree_leaves(live)]

    want = run(D.LocalDist())
    D.form_group(0, 1, str(tmp_path / "store"), backend="nccl", device="cuda")
    try:
        got = run(D.ProcessGroupDist())
    finally:
        D.tdist.destroy_process_group()
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), i


# Under Dynamic Axial Parallelism each rank calls a kernel on its own rows
# (groups for the attention, rows i for the triangle update and the
# outer-product-mean) with the gathered operands whole. A kernel whose
# arithmetic depends on where a row lies in the call, or on which block
# takes its tile, makes the ranks' rows differ from the one-device call's
# and the bf16 fold drift away through the blocks. Each rank's shard, at
# the shapes of N = 2 and 4 at r = 256, s = 128 (FULL widths), must give
# the whole call's rows to the bit.
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel", ["attention", "triangle", "opm"])
def test_kernel_shard_of_rows_is_the_whole_calls_rows(gen, kernel, n):
    bf = torch.bfloat16
    s, r = 128, 256
    if kernel == "attention":
        h, hd = 4, 32
        y = _randn(gen, (1, r, r, 3 * h * hd), 1.0, bf)
        bias = _randn(gen, (1, h, r, r), 1.0, bf)
        mask = torch.where(torch.rand((1, r, r), generator=gen,
                                      device="cuda") < 0.9, 0.0, -1e9)

        def call(rows):
            q, k, v = (t.unflatten(-1, (h, hd)) for t in torch.split(
                y[:, rows], h * hd, dim=-1))
            return ops.fused_attention(q, k, v, bias=bias,
                                       mask=mask[:, rows].contiguous())
    elif kernel == "triangle":
        c = d = 128
        ab = _randn(gen, (1, r, r, 2 * c), 1.0, bf)
        g = _randn(gen, (1, r, r, 2 * c), 2.0, bf)
        pmask = (torch.rand((1, r, r), generator=gen, device="cuda")
                 < 0.9).float()
        b_full = _randn(gen, (1, r, r, c), 1.0, bf)
        g_lin = _randn(gen, (1, r, r, d), 2.0, bf)
        rest = [1 + _randn(gen, (c,), 0.1), _randn(gen, (c,), 0.1),
                _randn(gen, (c, d), c ** -0.5), _randn(gen, (d,), 0.1)]
        g_bias = _randn(gen, (d,))

        def call(rows):
            a_rows = ab[:, rows].contiguous()
            g_rows = g[:, rows].contiguous()
            return ops.fused_triangle_mult(
                a_rows[..., :c], g_rows[..., :c], pmask[:, rows].contiguous(),
                b_full, *rest, g_lin[:, rows].contiguous(), g_bias)
    else:
        c, d = 32, 128
        mask = (torch.rand((1, s, r), generator=gen, device="cuda")
                < 0.9).float()
        a = _randn(gen, (1, s, r, c), 1.0, bf) * mask[..., None].to(bf)
        b = _randn(gen, (1, s, r, c), 1.0, bf) * mask[..., None].to(bf)
        w, bias = _randn(gen, (c * c, d), 1.0 / c, bf), _randn(gen, (d,))

        def call(rows):
            return ops.fused_outer_product_mean(
                a[:, :, rows].contiguous(), b, mask[:, :, rows].contiguous(),
                mask, w, bias)
    whole = call(slice(0, r))
    size = r // n
    for rank in range(n):
        rows = slice(rank * size, (rank + 1) * size)
        assert torch.equal(call(rows), whole[:, rows]), rank


# The decoder LMs (the LM serving engine): musicgen-medium's every
# LayerNorm is K1 at C = 1536, rows of a prefill (1, S, 1536) and of the
# batched decode (4, 1, 1536). bf16 takes the vector kernel (32 lanes of 6
# vectors a row), fp32 the loop (12 vectors a lane is over the envelope).
@pytest.mark.parametrize("dtype,tol,vector", [(torch.float32, 1e-5, False),
                                              (torch.bfloat16, 1e-2, True)])
@pytest.mark.parametrize("shape", [(1, 32, 1536), (1, 256, 1536),
                                   (4, 1, 1536)])
def test_layer_norm_kernel_at_the_decoders_width(gen, shape, dtype, tol,
                                                  vector):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    gamma = torch.randn(1536, generator=gen, device="cuda") * 0.1 + 1
    beta = torch.randn(1536, generator=gen, device="cuda") * 0.1
    assert (ln_partition(1536, x.element_size()) == (32, 6, 8)) == vector
    assert (ln_partition(1536, x.element_size()) is None) == (not vector)
    _build.reset_launches()
    got = ops.layer_norm(x, gamma, beta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["layer_norm"] == 1
    _close(got, ref.layer_norm_ref(x, gamma, beta), tol)


def _serve_on_the_card(cfg, seed, n_new=6):
    """``cfg`` served on the card (bf16) from weights drawn on the CPU
    and copied there: (CPU weights, prompts, requests, K1 launches,
    other kernels' launches)."""
    from repro_torch.layers.params import tree_map
    from repro_torch.models.decoder import init_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.weights import random_params_like

    with torch.device("meta"):
        skeleton = init_model(torch.Generator(), cfg)
    cpu = random_params_like(skeleton, seed, device="cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=torch.Generator()
                             .manual_seed(n)).numpy() for n in (5, 9, 12)]
    eng = ServingEngine(card, cfg, n_slots=2, max_seq=32)
    _build.reset_launches()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    return (cpu, prompts, reqs, launches.pop("layer_norm", 0),
            {k: v for k, v in launches.items() if v})


def _assert_cpu_fp32_greedy(cpu, cfg, prompts, reqs, n_new=6):
    """Each request's tokens equal sequential greedy decoding with the
    port's fp32 ``model_forward`` on the CPU, up to the first step whose
    two candidates are a bf16 near tie of the fp32 logits (within
    2e-2·max(1, max|logits|); the sequences then go on from different
    tokens)."""
    from repro_torch.models.decoder import model_forward

    for prompt, req in zip(prompts, reqs):
        assert req.status == "done" and len(req.generated) == n_new
        toks = list(prompt)
        for i, tok in enumerate(req.generated):
            logits = model_forward(cpu, torch.as_tensor(toks)[None], cfg,
                                   compute_dtype=torch.float32)["logits"]
            logits = logits[0, -1]
            want = int(torch.argmax(logits))
            if tok != want:
                gap = float(logits[want] - logits[tok])
                assert gap <= 2e-2 * max(1.0, logits.abs().max().item()), (
                    i, tok, want, gap)
                break
            toks.append(tok)


def test_lm_engine_on_the_card_gives_the_cpu_fp32_greedy_tokens(gen):
    """musicgen-medium REDUCED served on the card (bf16, K1 at every
    LayerNorm) against sequential greedy decoding with the port's fp32
    ``model_forward`` on the CPU on the same weights."""
    from repro_torch.configs import get_config

    cfg = get_config("musicgen-medium", reduced_variant=True)
    cpu, prompts, reqs, k1, _ = _serve_on_the_card(cfg, 3)
    assert k1 > 0
    _assert_cpu_fp32_greedy(cpu, cfg, prompts, reqs)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b",
                                  "hymba-1.5b", "xlstm-125m"])
def test_lm_engine_serves_each_decoder_family_on_the_card(gen, arch):
    """The MoE, MLA, hymba and xLSTM kinds, REDUCED, served on the card
    (bf16; no kernel launched: all four are RMSNorm models) against the
    CPU's fp32 sequential greedy tokens, and served again to the same
    tokens (the MoE combine has no atomics). The MoE configs run at a
    capacity factor of 100, so that capacity equals the tokens of every
    call and a decode step is the recompute's routing; at the default
    capacity the prefill's 12 tokens would drop some."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch, reduced_variant=True)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=100.0))
    cpu, prompts, reqs, k1, others = _serve_on_the_card(cfg, 4)
    assert k1 == 0 and not others
    _assert_cpu_fp32_greedy(cpu, cfg, prompts, reqs)
    _, _, again, _, _ = _serve_on_the_card(cfg, 4)
    assert [r.generated for r in again] == [r.generated for r in reqs]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "yi-9b", "qwen1.5-32b",
                                  "gemma3-27b", "llava-next-mistral-7b",
                                  "musicgen-medium", "deepseek-moe-16b",
                                  "deepseek-v2-236b", "hymba-1.5b",
                                  "xlstm-125m"])
def test_lm_train_step_on_the_card_matches_the_cpu(gen, arch):
    """One training step of each decoder configuration, REDUCED:
    ``make_train_step`` over ``lm_loss`` at fp32 compute (each layer
    checkpointed), on the card and on the CPU from the same weights and
    batch; the loss, gradient norm, and every parameter and moment after
    the step within 1e-3·max(1, max|cpu|) (a learning rate of 1e-4, so
    that a first AdamW step, about ``lr · sign(g)``, stays inside the
    bound where a tiny gradient's sign differs). K1 launches 2 · n_layers + 1 in
    the forward and 2 · n_layers in the recompute on musicgen-medium, no
    kernel on the other nine."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.train import lm_batch
    from repro_torch.layers.params import tree_leaves, tree_map
    from repro_torch.models.decoder import init_model, lm_loss
    from repro_torch.train.loop import make_train_step
    from repro_torch.weights import random_params_like

    cfg = get_config(arch, reduced_variant=True)
    with torch.device("meta"):
        skeleton = init_model(torch.Generator(), cfg)
    cpu = random_params_like(skeleton, 5, device="cpu")
    lb = next(lm_batches(vocab=cfg.vocab, batch=2, seq=32, seed=1))
    states, metrics = {}, {}
    for dev in ("cpu", "cuda"):
        init, step = make_train_step(
            lambda p, b, r: lm_loss(p, b, cfg, compute_dtype=torch.float32),
            base_lr=1e-4, warmup_steps=1, total_steps=10)
        params = tree_map(lambda t: t.to(dev), cpu)
        _build.reset_launches()
        states[dev], metrics[dev] = step(init(params), lm_batch(lb, cfg, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = ({"layer_norm": 4 * cfg.n_layers + 1}
            if cfg.norm == "layernorm" else {})
    assert launches == want
    for k in ("loss", "grad_norm"):
        _close(metrics["cuda"][k].cpu(), metrics["cpu"][k], 1e-3)
    assert float(metrics["cuda"]["nonfinite_skips"]) == 0.0
    for tree in ("params", "m", "v"):
        pick = (lambda s: s.params) if tree == "params" else (
            lambda s, t=tree: getattr(s.opt_state, t))
        for g, w in zip(tree_leaves(pick(states["cuda"])),
                        tree_leaves(pick(states["cpu"]))):
            if w.numel():
                _close(g.cpu(), w, 1e-3)
