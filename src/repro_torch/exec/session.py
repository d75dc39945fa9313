"""FastFold facade for folding inference and training: bind a config, a
device, a compute dtype and an ``ExecutionPlan`` once.

    from repro_torch.configs import FULL
    from repro_torch.exec import (ExecutionPlan, FastFold, KernelPolicy,
                                  MemoryPolicy, preset)
    from repro_torch.train import make_train_step

    ff = FastFold(FULL)                         # on the card, current plan
    params = ff.init(seed=0)
    out = ff.forward(params, batch)             # batch: dict of arrays
    out = ff.forward(params, batch, rng=gen, train=True)   # with dropout
    outs = ff.serve(params, [batch_a, batch_b], plans=[None, preset("oracle")])
    loss, metrics = ff.train_loss(params, batch, generator=gen)
    init_state, step = make_train_step(ff.loss_fn)
    state, metrics = step(init_state(params), batch, gen)

    oracle_attn = FastFold(FULL, plan=ExecutionPlan(
        kernels=KernelPolicy(attention="oracle")))   # scores materialized
    long_fold = FastFold(FULL, plan=ExecutionPlan(memory=MemoryPolicy(
        hbm_budget=40 << 30)))        # AutoChunk plans against 40 GiB

``serve`` opens one ``fastfold.serve`` span a request (``repro_torch.obs``;
a no-op with no tracer scoped), the root of that fold's spans.

``device=None`` means the card and raises where there is none;
``device="cpu"`` runs every kernel's plain PyTorch version. ``plan=None``
binds the plan current when the facade is built (the innermost
``use_plan`` scope, else the environment's ``REPRO_PLAN``). Every entry
point runs under its plan (``use_plan``), a per-call ``plan=`` overriding
the bound one. Every forward resolves its chunk knobs from the plan's
``MemoryPolicy`` (``core.alphafold.planned_evoformer``).

Dynamic Axial Parallelism: bound to a plan whose ``ParallelPolicy`` is
``"gspmd"``, on every rank of an initialised process group (``mesh``: the
group, None for the default one; ``core.dist.form_group``), the facade runs
the whole model under DAP (``core.dist.WholeModelDist``): each rank holds
the whole batch and the whole parameters, the Evoformer stack runs on the
rank's shards, and each rank's outputs, loss and gradients are the whole
ones, equal on every rank; draw the dropout masks from generators seeded
alike. ``make_train_step(ff.loss_fn)`` then keeps the ranks' parameters
and optimizer states equal to the bit. The backend is built at
construction (``ParallelPolicy.make_dist``), so a plan with no group to
run on raises there.

    form_group(rank, world, "/tmp/store", backend="nccl")
    ff = FastFold(FULL, plan=ExecutionPlan().with_parallel(backend="gspmd"))
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import torch

from repro_torch.configs.alphafold import AlphaFoldConfig
from repro_torch.core.alphafold import (alphafold_forward,
                                        alphafold_train_loss,
                                        draw_dropout_keeps, init_alphafold)
from repro_torch.device import resolve_device
from repro_torch.exec.plan import ExecutionPlan, current_plan, use_plan
from repro_torch.layers.params import tree_map
from repro_torch.obs import trace as obs

# The features the forward reads, and those the training loss adds.
FEATURES = ("msa", "msa_mask", "residue_index", "aatype", "seq_mask")
TRAIN_FEATURES = ("pseudo_beta", "bert_mask", "true_msa")


class FastFold:
    """AlphaFold inference and training bound to one device, compute dtype
    and ExecutionPlan (overridable per call)."""

    def __init__(self, config: AlphaFoldConfig, *, device=None,
                 dtype: torch.dtype | None = None,
                 plan: ExecutionPlan | None = None):
        if dtype is not None:
            config = dataclasses.replace(config, compute_dtype=dtype)
        self.config = config
        self.device = resolve_device(device)
        self.plan = plan if plan is not None else current_plan()
        self.plan.parallel.make_dist()      # raises where no group exists

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

    def forward(self, params, batch: Mapping, *, rng=None, train: bool = False,
                n_recycle: int | None = None,
                plan: ExecutionPlan | None = None):
        """Full folding forward (recycling included) under the bound plan or
        ``plan``. ``train=True`` builds the graph of the last pass and
        applies dropout with masks drawn from ``rng`` (a
        ``torch.Generator``; None: no dropout, the same numbers as
        ``train=False``); with ``train=False`` ``rng`` is not used."""
        plan = self.plan if plan is None else plan
        batch = self.batch_to_device(batch)
        keeps = None
        if train and rng is not None:
            keeps = draw_dropout_keeps(self.config, batch["msa"].shape, rng,
                                       self.device)
        with use_plan(plan):
            return alphafold_forward(params, batch, self.config,
                                     n_recycle=n_recycle, train=train,
                                     keeps=keeps)

    def serve(self, params, batches: Iterable[Mapping], *, plans=None):
        """Folding-inference service entry: one forward per request.
        ``plans`` (optional, one per request, None for the bound plan)
        overrides the plan per request, e.g. an oracle canary beside
        default-plan requests."""
        batches = list(batches)
        if plans is None:
            plans = [None] * len(batches)
        plans = list(plans)
        if len(plans) != len(batches):
            raise ValueError(
                f"serve: {len(batches)} batches but {len(plans)} plans")
        outs = []
        for b, p in zip(batches, plans):
            n_batch, n_seq, n_res = b["msa"].shape
            with obs.span("fastfold.serve", batch=n_batch, n_seq=n_seq,
                          n_res=n_res):
                outs.append(self.forward(params, b, plan=p))
        return outs

    def train_loss(self, params, batch: Mapping, generator=None, *,
                   n_recycle: int | None = None,
                   plan: ExecutionPlan | None = None):
        """``(loss, metrics)`` of one training forward, recycling included,
        with activation checkpointing per Evoformer block, under the bound
        plan or ``plan``. Dropout masks are drawn from ``generator``; None
        means no dropout. The backward that follows takes the forward's
        legs and branches, wherever it runs."""
        with use_plan(self.plan if plan is None else plan):
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
