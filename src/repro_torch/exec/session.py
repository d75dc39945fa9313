"""FastFold facade for folding inference and training: bind a config, a
device and a compute dtype once.

    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.train import make_train_step

    ff = FastFold(FULL)                         # on the card
    params = ff.init(seed=0)
    out = ff.forward(params, batch)             # batch: dict of arrays
    outs = ff.serve(params, [batch_a, batch_b])
    loss, metrics = ff.train_loss(params, batch, generator=gen)
    init_state, step = make_train_step(ff.loss_fn)
    state, metrics = step(init_state(params), batch, gen)

``device=None`` means the card and raises where there is none;
``device="cpu"`` runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import torch

from repro_torch.configs.alphafold import AlphaFoldConfig
from repro_torch.core.alphafold import (alphafold_forward,
                                        alphafold_train_loss, init_alphafold)
from repro_torch.layers.params import tree_map

# The features the forward reads, and those the training loss adds.
FEATURES = ("msa", "msa_mask", "residue_index", "aatype", "seq_mask")
TRAIN_FEATURES = ("pseudo_beta", "bert_mask", "true_msa")


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


class FastFold:
    """AlphaFold inference and training bound to one device and compute
    dtype."""

    def __init__(self, config: AlphaFoldConfig, *, device=None,
                 dtype: torch.dtype | None = None):
        if dtype is not None:
            config = dataclasses.replace(config, compute_dtype=dtype)
        self.config = config
        self.device = resolve_device(device)

    def init(self, seed: int = 0):
        """Fresh parameters from a seeded CPU generator, on the device."""
        gen = torch.Generator().manual_seed(seed)
        return tree_map(lambda t: t.to(self.device),
                        init_alphafold(gen, self.config))

    def batch_to_device(self, batch: Mapping) -> dict[str, torch.Tensor]:
        """The forward's features, and the training features the batch
        holds, as tensors on the bound device."""
        return {k: torch.as_tensor(batch[k]).to(self.device)
                for k in FEATURES + TRAIN_FEATURES
                if k in FEATURES or k in batch}

    def forward(self, params, batch: Mapping, *, n_recycle: int | None = None):
        """Full folding forward (recycling included)."""
        return alphafold_forward(params, self.batch_to_device(batch),
                                 self.config, n_recycle=n_recycle)

    def serve(self, params, batches: Iterable[Mapping]):
        """Folding-inference service entry: one forward per request."""
        return [self.forward(params, b) for b in batches]

    def train_loss(self, params, batch: Mapping, generator=None, *,
                   n_recycle: int | None = None):
        """``(loss, metrics)`` of one training forward, recycling included,
        with activation checkpointing per Evoformer block. Dropout masks are
        drawn from ``generator``; None means no dropout."""
        return alphafold_train_loss(params, self.batch_to_device(batch),
                                    self.config, generator=generator,
                                    n_recycle=n_recycle)

    @property
    def loss_fn(self):
        """``(params, batch, rng) -> (loss, metrics)`` for
        ``train.make_train_step``; ``rng`` is a ``torch.Generator`` for the
        dropout masks, or None for no dropout."""
        def fn(params, batch, rng=None):
            return self.train_loss(params, batch, rng)

        return fn
