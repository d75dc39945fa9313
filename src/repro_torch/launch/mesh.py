"""Production meshes of H100s, and the card's constants for the roofline.

The reference's mesh is a JAX device mesh of TPU v5e chips (16x16 ICI
torus). The port's is a plain description of one: axis names and sizes,
with ``.shape`` (name -> size) and ``.size``; building it touches no device
and no process group. ``make_host_mesh`` builds a real
``torch.distributed`` ``DeviceMesh`` over the local devices, for a program
that has formed a process group.

Production layout: nodes of 8 H100 SXM cards joined by NVLink (a DGX
H100), the DAP ``model`` axis inside a node and the ``data`` (and ``pod``)
axes across nodes over InfiniBand: (32, 8) ``("data", "model")`` for 256
cards, (2, 32, 8) ``("pod", "data", "model")`` for 512, the paper's
512-GPU scale. ``mesh_of`` takes any shape (the reference's (16, 16)
cells, say).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch import device

# Hardware constants for the roofline, one NVIDIA H100 80GB HBM3 (SXM) at
# its full power limit of 700 W (a card set below it reaches less):
PEAK_FLOPS_BF16 = device.PEAK_FLOPS_BF16   # per card, NVIDIA's data sheet
HBM_BW = device.HBM_BW                     # bytes/s per card, data sheet
# The card's own ``torch.cuda.get_device_properties(0).total_memory`` on
# that card, as chip_smoke.py reads it (its ``card_total_bytes``).
HBM_BYTES = 85_017_493_504
# Published, not measured: NVLink 4 gives each H100 SXM 900 GB/s in both
# directions together (450 GB/s each way) to the cards of its node; a DGX
# H100 gives each card one 400 Gb/s InfiniBand port (50 GB/s each way) to
# the other nodes.
NVLINK_BW = 450e9                           # bytes/s per card, one way
IB_BW = 50e9                                # bytes/s per card, one way
GPUS_PER_NODE = 8


@dataclass(frozen=True)
class MeshShape:
    """A mesh as names and sizes, the reference's ``Mesh.shape`` without
    devices."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def __str__(self) -> str:
        return "x".join(str(s) for s in self.axis_sizes)


def mesh_of(shape, axes=None) -> MeshShape:
    """A mesh of ``shape``, its axes ``axes`` (default: ``("data",
    "model")`` or ``("pod", "data", "model")`` by its rank)."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                          "model")
    if len(axes) != len(shape):
        raise ValueError(f"mesh {shape} has {len(shape)} axes, not {axes}")
    return MeshShape(tuple(axes), shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    return mesh_of((2, 32, 8) if multi_pod else (32, 8))


def link_bw(mesh: MeshShape, axis: str) -> float:
    """The per-card rate a collective over ``axis`` runs at: NVLink when
    the axis fits in a node (the ``model`` axis of up to 8 cards),
    InfiniBand otherwise."""
    if axis == "model" and mesh.shape.get("model", 1) <= GPUS_PER_NODE:
        return NVLINK_BW
    return IB_BW


def make_host_mesh(model: int = 1, data: int | None = None):
    """A ``DeviceMesh`` ``("data", "model")`` over the default process
    group's ranks (tests, examples); raises where no group is formed."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    if not tdist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (core.dist.form_group)")
    n = tdist.get_world_size()
    data = data or (n // model)
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))
