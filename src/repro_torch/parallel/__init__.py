"""Sharding plans over the mesh axes (``parallel.plan``)."""
from repro_torch.parallel import plan  # noqa: F401
