"""The host side of the bias-dropout-add kernel (K3), on the CPU: the kernel
itself runs only on the card (tests/test_torch_cuda.py).

``broadcast_strides`` gives the keep mask's strides against the update
without building the ``expand`` view; ``_bda_geometry`` makes the checks
that depend only on shapes, layouts and dtypes once per distinct key and
caches the launch geometry the kernel's entry point reads. Both are pure
host code and are held here against ``keep.expand(shape).stride()`` and
the rules the wrapper states.
"""
import pytest
import torch

from repro_torch.core.evoformer import DROPOUT_SITES
from repro_torch.kernels import fused_elementwise as fe

# The main path's update shapes: the MSA row site at (B, s, r, 256), the
# pair sites at (B, r, r, 128), FULL widths, s = 128, r = 256.
_MSA, _PAIR = (128, 256, 256), (256, 256, 128)


def _site_shapes(site: str, batch: int):
    shape = (batch,) + (_MSA if site == "msa_row" else _PAIR)
    axis = DROPOUT_SITES[site]
    keep = tuple(1 if i == axis else n for i, n in enumerate(shape))
    return shape, keep


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("site", list(DROPOUT_SITES))
def test_broadcast_strides_main_path(site, batch):
    shape, kshape = _site_shapes(site, batch)
    keep = torch.empty(kshape)
    got = fe.broadcast_strides(shape, keep.shape, keep.stride())
    assert got == keep.expand(shape).stride()
    # The shared axis reads stride 0; the channels are contiguous.
    assert got[DROPOUT_SITES[site]] == 0 and got[-1] == 1


# (x shape, keep shape): ranks 1 to 4, leading axes the mask lacks, size-1
# axes that do and do not grow, a full-size mask.
BROADCASTS = [
    ((64,), (64,)),
    ((64,), (1,)),
    ((5, 16), (16,)),
    ((5, 16), (5, 1)),
    ((1, 5, 16), (1, 1, 16)),
    ((3, 5, 16), (3, 5, 16)),
    ((2, 3, 5, 16), (1, 3, 1, 16)),
    ((2, 3, 5, 16), (5, 16)),
    ((2, 3, 5, 16), (2, 1, 5, 1)),
]


@pytest.mark.parametrize("shape,kshape", BROADCASTS,
                         ids=[f"{s}-{k}" for s, k in BROADCASTS])
def test_broadcast_strides_ranks(shape, kshape):
    keep = torch.empty(kshape)
    assert (fe.broadcast_strides(shape, keep.shape, keep.stride())
            == keep.expand(shape).stride())


def test_broadcast_strides_of_a_view():
    """A mask that is itself a strided view keeps its own strides."""
    base = torch.empty(4, 7, 32)
    keep = base[:, 2:3, ::2]                   # (4, 1, 16), strides (224, 32, 2)
    shape = (4, 9, 16)
    assert (fe.broadcast_strides(shape, keep.shape, keep.stride())
            == keep.expand(shape).stride())


# Masks that do not broadcast: a wrong extent, more dims than x.
NOT_BROADCASTING = [
    ((4, 8), (3, 1)),
    ((2, 3, 5, 16), (2, 3, 5, 8)),
    ((2, 3, 5, 16), (1, 2, 1, 16)),
    ((16,), (1, 16)),
    ((1, 256, 256, 128), (1, 256, 1, 256)),
]


@pytest.mark.parametrize("shape,kshape", NOT_BROADCASTING,
                         ids=[f"{s}-{k}" for s, k in NOT_BROADCASTING])
def test_broadcast_strides_refuses(shape, kshape):
    keep = torch.empty(kshape)
    with pytest.raises(RuntimeError):
        keep.expand(shape)
    with pytest.raises(ValueError, match="broadcast"):
        fe.broadcast_strides(shape, keep.shape, keep.stride())


@pytest.mark.parametrize("site", list(DROPOUT_SITES))
def test_geometry_main_path(site):
    shape, kshape = _site_shapes(site, 1)
    x = torch.empty(shape, dtype=torch.bfloat16)
    keep = torch.empty(kshape)
    key = ("test", site)
    fe._BDA_GEOM.pop(key, None)
    geom = fe._bda_geometry("f", x, keep, key)
    dims, strides = tuple(geom[:4]), tuple(geom[4:8])
    assert dims == shape
    assert strides == keep.expand(shape).stride()
    assert tuple(geom[8:]) == (1, 0)           # bf16, an fp32 mask
    # Cached under its key: the checks run once per distinct key.
    assert fe._BDA_GEOM[key] is geom
    fe._BDA_GEOM.pop(key)


@pytest.mark.parametrize("shape,kshape,keep_dtype,code", [
    ((40, 16), None, None, 0),
    ((7, 16), (7, 1), torch.bool, 1),
    ((3, 5, 16), (1, 5, 16), torch.uint8, 1),
])
def test_geometry_pads_to_four_dims(shape, kshape, keep_dtype, code):
    x = torch.empty(shape)
    keep = None if kshape is None else torch.zeros(kshape, dtype=keep_dtype)
    key = ("test", shape)
    fe._BDA_GEOM.pop(key, None)
    geom = fe._bda_geometry("f", x, keep, key)
    lead = 4 - len(shape)
    assert tuple(geom[:4]) == (1,) * lead + shape
    want = ((0,) * 4 if keep is None else
            (0,) * lead + keep.expand(shape).stride())
    assert tuple(geom[4:8]) == want
    assert tuple(geom[8:]) == (0, code)        # fp32 x, the mask's code
    fe._BDA_GEOM.pop(key)


@pytest.mark.parametrize("shape,keep,err,match", [
    ((4, 6), None, ValueError, "C % 8"),
    ((2, 3, 4, 5, 8), None, ValueError, "1 to 4 dims"),
    ((70000, 2, 3, 8), None, ValueError, "grid"),
    ((4, 8), torch.zeros((4, 8), dtype=torch.int32), TypeError, "keep"),
    ((4, 8), torch.zeros((3, 1)), ValueError, "broadcast"),
])
def test_geometry_refuses(shape, keep, err, match):
    x = torch.empty(shape, device="meta")
    if keep is not None:
        keep = keep.to("meta")
    with pytest.raises(err, match=match):
        fe._bda_geometry("f", x, keep, ("refused",))
    assert ("refused",) not in fe._BDA_GEOM


def test_geometry_refuses_other_dtypes():
    with pytest.raises(TypeError, match="dtype"):
        fe._bda_geometry("f", torch.empty((4, 8), dtype=torch.float16),
                         None, ("refused",))
    assert ("refused",) not in fe._BDA_GEOM


def test_wrapper_refuses_cpu_tensors_before_any_check():
    x = torch.randn(4, 6)                       # C % 8 would fail too
    with pytest.raises(ValueError, match="CUDA"):
        fe.bias_dropout_add_cuda(x, None, x, torch.ones(4, 1), 0.25)
