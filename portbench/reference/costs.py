"""The work a kernel site must do, and the FLOPs a model must compute.

Frozen copies of the port's cost arithmetic (``roofline/analysis.py`` of
``repro_torch``: the fused ops' FLOPs and bytes, the 2·M·N·K count of a
matrix product, the card's published peaks), applied here to the sites and
products of ``reference.alphafold``, so the count is the same whatever
implements a site.

``site_work(work, dims)`` gives (FLOPs, bytes) of one site: every input
read once and every output written once, at the byte widths the program
holds them in (``x_bytes`` the activations', 4 for masks, parameters and
fp32 statistics). ``bound_s`` is the least time the card needs for it.
``count_flops`` counts the matrix products a function runs (on ``meta``
tensors it computes nothing).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# One NVIDIA H100 SXM (data sheet; dense, at the full 700 W power limit).
PEAK_FLOPS = 989e12     # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12        # bytes/s


def _layer_norm(n, c, x_bytes):
    return 0.0, 2 * n * x_bytes + 2 * c * 4


def _bias_sigmoid_mul(n, c, x_bytes):
    return 0.0, 3 * n * x_bytes + c * 4


def _bias_dropout_add(n, keep, x_bytes):
    return 0.0, 3 * n * x_bytes + keep * 4


def _attention_fwd(n, sq, skv, h, d, bias, x_bytes):
    flops = 4.0 * n * h * sq * skv * d
    io = ((n * sq * h * d + 2 * n * skv * h * d + bias + n * sq * h * d)
          * x_bytes + n * skv * 4 + n * h * sq * 4)
    return flops, io


def _attention_bwd(n, sq, skv, h, d, bias, x_bytes):
    flops = 10.0 * n * h * sq * skv * d
    q = n * sq * h * d
    kv = 2 * n * skv * h * d
    # q, k, v, out, do and bias in; dq, dk, dv and dbias out; lse and mask.
    io = (2 * (q + kv + bias) + 2 * q) * x_bytes + n * h * sq * 4 + n * skv * 4
    return flops, io


def _softmax_at_attention(n, sq, skv, h, d, bias, x_bytes):
    """The scores' softmax of an attention site: scores, bias and mask in,
    probabilities out (the materialized branch's K4)."""
    scores = n * h * sq * skv
    return 0.0, (2 * scores + bias) * x_bytes + n * skv * 4


def _triangle_mult(b, i, j, k, c, dz, x_bytes):
    flops = 2.0 * b * i * j * c * (k + dz)
    io = ((2 * b * i * k * c + b * j * k * c + 2 * b * i * j * dz) * x_bytes
          + (b * i * k + 2 * c + c * dz + 2 * dz) * 4 + 2 * 4 * b * i * j)
    return flops, io


def _outer_product_mean(b, s, i, j, c, dz, x_bytes):
    flops = 2.0 * b * i * j * s * (c * c + 1) + 2.0 * b * i * j * c * c * dz
    io = ((b * s * i * c + b * s * j * c + b * i * j * dz) * x_bytes
          + (b * s * i + b * s * j + c * c * dz + dz) * 4)
    return flops, io


WORK = {
    "layer_norm": _layer_norm,
    "bias_sigmoid_mul": _bias_sigmoid_mul,
    "bias_dropout_add": _bias_dropout_add,
    "attention_fwd": _attention_fwd,
    "attention_bwd": _attention_bwd,
    "softmax_at_attention": _softmax_at_attention,
    "triangle_mult": _triangle_mult,
    "outer_product_mean": _outer_product_mean,
}


def site_work(work: str, dims: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one site under the formula ``work``."""
    return WORK[work](**dims)


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card needs: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}


class _FlopMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            a, b = args[-2], args[-1]
            if func in (_aten.addmm.default, _aten.baddbmm.default):
                a, b = args[1], args[2]
            self.flops += 2.0 * a.numel() * b.shape[-1]
        return func(*args, **(kwargs or {}))


def count_flops(fn, *args, **kwargs) -> tuple[float, object]:
    """(FLOPs of the matrix products ``fn`` runs, its result)."""
    mode = _FlopMode()
    with mode:
        out = fn(*args, **kwargs)
    return mode.flops, out
