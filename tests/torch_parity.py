"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded inputs, tolerances, and conversion between the two.

Tolerances scale with the reference's magnitude:
  fp32  max|port - jax| <= 1e-4 * max(1, max|jax|) per module,
        and <= 1e-3 * max(1, max|jax|) for the whole forward;
  bf16  max|port - jax| <= 2e-2 * max(1, max|jax|), the bound of
        tests/test_triangle.py for bf16 — one bf16 rounding of an O(1) value
        is 2**-8 relative, and the two frameworks round at a few different
        places inside a module.
"""
import jax.numpy as jnp
import numpy as np
import torch

# The reference runs at jax_default_matmul_precision="highest"
# (tests/conftest.py); the port's float32 products stay in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODULE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FORWARD_TOL = {"float32": 1e-3}

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(port, ref, tol: float, what: str = ""):
    """max|port - ref| <= tol * max(1, max|ref|)."""
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.isfinite(p).all(), f"{what}: port output not finite"
    err = float(np.max(np.abs(p - r))) if p.size else 0.0
    bound = tol * max(1.0, float(np.max(np.abs(r))) if r.size else 0.0)
    assert err <= bound, f"{what}: max|port - jax| = {err:.3g} > {bound:.3g}"


def normal(rng: np.random.Generator, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def both(x: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch CPU tensor."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)
