"""FastFold facade for folding inference: bind a config, a device and a
compute dtype once.

    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold

    ff = FastFold(FULL)                         # on the card
    params = ff.init(seed=0)
    out = ff.forward(params, batch)             # batch: dict of arrays
    outs = ff.serve(params, [batch_a, batch_b])

``device=None`` means the card and raises where there is none;
``device="cpu"`` runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import torch

from repro_torch.configs.alphafold import AlphaFoldConfig
from repro_torch.core.alphafold import alphafold_forward, init_alphafold

# The features the forward reads.
FEATURES = ("msa", "msa_mask", "residue_index", "aatype", "seq_mask")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise rather than run quietly on
    the CPU; ``device="cpu"`` is the explicit opt-in the tests use."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_to(tree, device):
    """Move a nested dict/list of tensors to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


class FastFold:
    """AlphaFold folding inference bound to one device and compute dtype."""

    def __init__(self, config: AlphaFoldConfig, *, device=None,
                 dtype: torch.dtype | None = None):
        if dtype is not None:
            config = dataclasses.replace(config, compute_dtype=dtype)
        self.config = config
        self.device = resolve_device(device)

    def init(self, seed: int = 0):
        """Fresh parameters from a seeded CPU generator, on the device."""
        gen = torch.Generator().manual_seed(seed)
        return tree_to(init_alphafold(gen, self.config), self.device)

    def batch_to_device(self, batch: Mapping) -> dict[str, torch.Tensor]:
        """The forward's features as tensors on the bound device."""
        return {k: torch.as_tensor(batch[k]).to(self.device)
                for k in FEATURES}

    def forward(self, params, batch: Mapping, *, n_recycle: int | None = None):
        """Full folding forward (recycling included)."""
        return alphafold_forward(params, self.batch_to_device(batch),
                                 self.config, n_recycle=n_recycle)

    def serve(self, params, batches: Iterable[Mapping]):
        """Folding-inference service entry: one forward per request."""
        return [self.forward(params, b) for b in batches]
