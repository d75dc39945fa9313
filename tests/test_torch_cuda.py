"""The port's CUDA kernels on the card against their plain versions, at
small shapes, and the launch counters. Marked ``cuda``: each test skips
where no CUDA device is present. This file imports no JAX, so it also runs
on a machine without it:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,sq,skv,h,d,nb,bias,mask", [
    (6, 40, 40, 2, 32, 2, True, True),      # rep 3
    (3, 20, 70, 2, 16, 1, True, True),      # ragged last KV tile
    (2, 130, 130, 1, 32, 1, False, False),  # ragged q tile, no bias/mask
    (4, 12, 12, 2, 16, 4, False, True),
])
def test_flash_attention_kernel(gen, n, sq, skv, h, d, nb, bias, mask, dtype,
                                tol):
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
    _build.reset_launches()
    out, lse = flash_attention_cuda(q, k, v, b, m, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd"] == 1
    want, want_lse = ref.attention_ref(q, k, v, b, m, d ** -0.5)
    _close(out, want, tol)
    _close(lse, want_lse, 1e-4)


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
