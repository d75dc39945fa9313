"""End-to-end AlphaFold-2: embedders, recycling, the Evoformer trunk, the
structure module and the heads, for folding inference and for the training
loss.

Chunking: ``alphafold_forward`` applies the current plan's
``MemoryPolicy`` overrides to the Evoformer config, then resolves every
chunk knob left at 0 through the AutoChunk planner (``planned_evoformer``,
as ``memory.autochunk.resolve_evoformer_config`` resolves them), once per
forward, as the reference does: the least-chunked settings whose modelled
peak fits the budget, no chunking where everything fits. The budget is
``hbm_budget=``, else the plan's ``MemoryPolicy.hbm_budget``, else the
device's (``device.hbm_budget_bytes``: the card's memory less what is
allocated when the forward starts); the planner gets it less what the
forward keeps live outside the Evoformer block
(``memory.autochunk.outside_block_bytes``). Knobs set by hand and
``auto_chunk=False`` opt out. The recycling loop is a Python loop.

Spans (``repro_torch.obs``; no-ops with no tracer scoped):
``alphafold.plan`` around the chunk plan (its ``ChunkPlan`` as
attributes), ``alphafold.pass`` around each recycling iteration (index,
last, grad), and inside one ``alphafold.embed``, ``evoformer.stack``
(n_blocks, remat), ``structure.module`` and ``alphafold.heads``. No span
opens inside an Evoformer block: a checkpointed block recomputes on
autograd's thread, where spans are no-ops.

Dynamic Axial Parallelism (the reference's ``GspmdDist`` role): under a
plan whose ``ParallelPolicy`` is ``"gspmd"`` (``core.dist.WholeModelDist``
on a process group) the embedding, structure module, heads and loss run on
every rank on the whole batch, and only the Evoformer stack is sharded
(``core.dap.whole_model_evoformer``); AutoChunk plans each rank's shard. A
``"shard_map"`` backend runs the stack on shards its caller made
(``core.dap.dap_evoformer_stack``), so a whole model under it raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.alphafold import AlphaFoldConfig, EvoformerConfig
from repro_torch.core.dap import whole_model_evoformer
from repro_torch.core.dist import LocalDist
from repro_torch.core.evoformer import (DROPOUT_SITES, evoformer_stack,
                                        init_evoformer_stack)
from repro_torch.core.losses import alphafold_loss
from repro_torch.core.structure import init_structure_module, structure_module
from repro_torch.data.synthetic import N_AA, N_MSA_TOK
from repro_torch.device import hbm_budget_bytes
from repro_torch.exec.plan import current_plan
from repro_torch.layers.norms import init_layer_norm, layer_norm
from repro_torch.layers.params import Params, dense, init_dense
from repro_torch.memory.autochunk import (ChunkPlan, apply_plan,
                                          evoformer_chunk_plan,
                                          outside_block_bytes)
from repro_torch.obs import trace as obs

RELPOS_K = 32
N_DIST_BINS = 64


def init_alphafold(generator: torch.Generator, cfg: AlphaFoldConfig) -> Params:
    """Fresh parameters on the CPU, with the reference's shapes and scheme:
    truncated-normal fan-in weights, zero-initialised output projections,
    gate biases of one."""
    d_m, d_z = cfg.d_msa, cfg.d_pair
    g = generator
    return {
        "msa_embed": init_dense(g, N_MSA_TOK, d_m, bias=True),
        "target_embed_m": init_dense(g, N_AA, d_m, bias=True),
        "left_embed": init_dense(g, N_AA, d_z, bias=True),
        "right_embed": init_dense(g, N_AA, d_z, bias=True),
        "relpos_embed": init_dense(g, 2 * RELPOS_K + 1, d_z, bias=True),
        "recycle": {
            "ln_m": init_layer_norm(d_m),
            "ln_z": init_layer_norm(d_z),
            "dist_embed": init_dense(g, cfg.recycle_bins, d_z, bias=True),
        },
        "evoformer": init_evoformer_stack(g, cfg.evoformer),
        "single_proj": init_dense(g, d_m, cfg.structure.c_s, bias=True),
        "structure": init_structure_module(g, cfg.structure),
        "msa_head": init_dense(g, d_m, N_MSA_TOK, bias=True),
        "dist_head": init_dense(g, d_z, N_DIST_BINS, bias=True),
    }


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``'s form, a comparison with ``arange(n)``: the same
    ops on every device (``torch.nn.functional.one_hot`` checks its range on
    the CPU only)."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def embed_inputs(params, batch, cfg: AlphaFoldConfig):
    """batch: msa (B,s,r) int, aatype (B,r) int, residue_index (B,r) int."""
    dt = cfg.compute_dtype
    msa_oh = _one_hot(batch["msa"], N_MSA_TOK, dt)
    aa_oh = _one_hot(batch["aatype"], N_AA, dt)
    msa_rep = dense(params["msa_embed"], msa_oh)
    msa_rep = msa_rep + dense(params["target_embed_m"], aa_oh)[:, None]
    left = dense(params["left_embed"], aa_oh)
    right = dense(params["right_embed"], aa_oh)
    pair = left[:, :, None, :] + right[:, None, :, :]
    ri = batch["residue_index"]
    rel = torch.clamp(ri[:, :, None] - ri[:, None, :], -RELPOS_K,
                      RELPOS_K) + RELPOS_K
    pair = pair + dense(params["relpos_embed"],
                        _one_hot(rel, 2 * RELPOS_K + 1, dt))
    return msa_rep, pair


def embed_recycle(params, msa, pair, prev, cfg: AlphaFoldConfig):
    """Add recycled features: LN'ed previous reps and a binned distance
    embedding of the previous predicted positions."""
    prev_msa_row, prev_pair, prev_pos = prev
    msa = msa.clone()
    msa[:, 0] += layer_norm(params["recycle"]["ln_m"],
                            prev_msa_row).to(msa.dtype)
    pair = pair + layer_norm(params["recycle"]["ln_z"],
                             prev_pair).to(pair.dtype)
    d = torch.linalg.norm(prev_pos[:, :, None] - prev_pos[:, None] + 1e-8,
                          dim=-1)
    edges = torch.linspace(3.375, 21.375, cfg.recycle_bins - 1,
                           dtype=torch.float32, device=d.device)
    bins = torch.sum(d[..., None] > edges, dim=-1)
    pair = pair + dense(params["recycle"]["dist_embed"],
                        _one_hot(bins, cfg.recycle_bins, pair.dtype))
    return msa, pair


def _evoformer(params, msa, pair, msa_mask, seq_mask, pair_mask, *, cfg,
               keeps, remat, dist):
    if dist.whole_model:
        return whole_model_evoformer(params, msa, pair, msa_mask, seq_mask,
                                     pair_mask, cfg=cfg, dist=dist,
                                     keeps=keeps, remat=remat)
    if not isinstance(dist, LocalDist):
        raise ValueError(
            f"{type(dist).__name__} runs the Evoformer on shards its caller "
            "made (core.dap.dap_evoformer_stack); the whole model under DAP "
            "is ParallelPolicy('gspmd')")
    return evoformer_stack(params, msa, pair, msa_mask, seq_mask, pair_mask,
                           cfg=cfg, keeps=keeps, remat=remat, dist=dist)


def alphafold_iteration(params, batch, prev, cfg: AlphaFoldConfig, *,
                        keeps: list[dict] | None = None, remat: bool = False,
                        dist=None):
    """One recycling iteration: embed -> Evoformer -> structure + heads.
    ``keeps``: the Evoformer's dropout masks, or None; ``remat``: per-block
    activation checkpointing; ``dist``: the backend (None: the current
    plan's)."""
    if dist is None:
        dist = current_plan().parallel.make_dist()
    dt = cfg.compute_dtype
    with obs.span("alphafold.embed"):
        msa, pair = embed_inputs(params, batch, cfg)
        msa, pair = embed_recycle(params, msa, pair, prev, cfg)
        msa = msa.to(dt)
        pair = pair.to(dt)

    seq_mask = batch["seq_mask"]
    pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
    with obs.span("evoformer.stack", n_blocks=cfg.evoformer.n_blocks,
                  remat=int(remat)):
        msa, pair = _evoformer(params["evoformer"], msa, pair,
                               batch["msa_mask"], seq_mask, pair_mask,
                               cfg=cfg.evoformer, keeps=keeps, remat=remat,
                               dist=dist)

    with obs.span("structure.module"):
        single = dense(params["single_proj"], msa[:, 0].float())
        coords, frames, traj = structure_module(params["structure"], single,
                                                pair.float(), seq_mask,
                                                cfg.structure)
    with obs.span("alphafold.heads"):
        msa_logits = dense(params["msa_head"], msa.float())
        distogram_logits = dense(params["dist_head"], pair.float())
    return {
        "msa": msa,
        "pair": pair,
        "coords": coords,
        "frames": frames,
        "traj": traj,
        "msa_logits": msa_logits,
        "distogram_logits": distogram_logits,
    }


def planned_evoformer(cfg: AlphaFoldConfig, batch_shape, *, device,
                      hbm_budget: int | None = None
                      ) -> tuple[EvoformerConfig, ChunkPlan | None, int]:
    """The Evoformer config a forward of ``batch_shape`` (B, s, r) on
    ``device`` runs under the current plan, the AutoChunk plan that filled
    it (None with ``auto_chunk`` off), and the budget the planner got: the
    fold's budget less ``outside_block_bytes``."""
    with obs.span("alphafold.plan"):
        plan = current_plan()
        dist = plan.parallel.make_dist()
        evo = plan.memory.apply(cfg.evoformer)
        b, s, r = batch_shape
        budget = (hbm_budget if hbm_budget is not None
                  else plan.memory.hbm_budget or hbm_budget_bytes(device))
        budget -= sum(outside_block_bytes(evo, batch=b, n_seq=s, n_res=r,
                                          dtype=cfg.compute_dtype).values())
        if not evo.auto_chunk:
            return evo, None, budget
        chunks = evoformer_chunk_plan(
            evo, batch=b, n_seq=s, n_res=r, dap=dist.axis_size,
            budget_bytes=budget, device=device, dtype=cfg.compute_dtype)
        if obs.current_tracer() is not None:
            obs.annotate(**{f.name: int(getattr(chunks, f.name))
                            for f in dataclasses.fields(chunks)})
        return apply_plan(evo, chunks), chunks, budget


def alphafold_forward(params, batch, cfg: AlphaFoldConfig, *,
                      n_recycle: int | None = None, train: bool = False,
                      keeps: list[dict] | None = None, remat: bool = False,
                      hbm_budget: int | None = None):
    """Full forward with recycling (``n_recycle`` extra passes, default the
    config's). ``batch`` is a dict of tensors on the parameters' device.

    Inference (``train=False``) runs under ``torch.inference_mode`` with no
    dropout. Training runs the pre-final passes under ``torch.no_grad`` (the
    reference's stop_gradient over its recycling loop) and builds the graph
    in the last pass only; every pass applies the same dropout masks
    ``keeps`` (the reference hands one rng to all of them), and ``remat``
    checkpoints each Evoformer block of the last pass. Both resolve the
    chunk knobs first (``planned_evoformer``; ``hbm_budget`` overrides the
    plan's and the device's budget)."""
    b, s, r = batch["msa"].shape
    dev = batch["msa"].device
    dist = current_plan().parallel.make_dist()
    evo, _, _ = planned_evoformer(cfg, (b, s, r), device=dev,
                                  hbm_budget=hbm_budget)
    if evo != cfg.evoformer:
        cfg = dataclasses.replace(cfg, evoformer=evo)
    if n_recycle is None:
        n_recycle = cfg.n_recycle

    def zeros_prev():
        return (
            torch.zeros((b, r, cfg.d_msa), dtype=torch.float32, device=dev),
            torch.zeros((b, r, r, cfg.d_pair), dtype=torch.float32,
                        device=dev),
            torch.zeros((b, r, 3), dtype=torch.float32, device=dev),
        )

    def recycle(prev):
        for i in range(n_recycle):
            with obs.span("alphafold.pass", index=i, last=0,
                          grad=int(torch.is_grad_enabled())):
                out = alphafold_iteration(params, batch, prev, cfg,
                                          keeps=keeps, dist=dist)
                prev = (out["msa"][:, 0].float(), out["pair"].float(),
                        out["coords"])
                # Only prev crosses into the next pass (outside_block_bytes).
                del out
        return prev

    def last_pass(prev, **kw):
        with obs.span("alphafold.pass", index=n_recycle, last=1,
                      grad=int(torch.is_grad_enabled())):
            return alphafold_iteration(params, batch, prev, cfg, dist=dist,
                                       **kw)

    if not train:
        keeps = None
        with torch.inference_mode():
            return last_pass(recycle(zeros_prev()))
    with torch.no_grad():
        prev = recycle(zeros_prev())
    return last_pass(prev, keeps=keeps, remat=remat)


def draw_dropout_keeps(cfg: AlphaFoldConfig, batch_shape, generator,
                       device=None) -> list[dict]:
    """Every Evoformer block's dropout masks for one step, drawn once from
    the explicit ``generator`` (on ``device``): per block and site of
    ``DROPOUT_SITES`` a Bernoulli(1 - rate) 0/1 fp32 mask at the reduced
    shape, size 1 along the axis that shares one draw. ``batch_shape`` is
    the MSA's (B, s, r); ``device`` defaults to the generator's. They are
    drawn here, outside any checkpointed block, so a recompute sees the
    same masks."""
    b, s, r = batch_shape
    evo = cfg.evoformer
    widths = {"msa_row": (s, r, evo.d_msa, evo.dropout_msa)}
    for site in DROPOUT_SITES:
        if site != "msa_row":
            widths[site] = (r, r, evo.d_pair, evo.dropout_pair)
    keeps = []
    for _ in range(evo.n_blocks):
        block = {}
        for site, axis in DROPOUT_SITES.items():
            d1, d2, c, rate = widths[site]
            shape = [b, d1, d2, c]
            shape[axis] = 1
            u = torch.rand(shape, generator=generator,
                           device=generator.device)
            block[site] = (u < 1.0 - rate).float().to(device)
        keeps.append(block)
    return keeps


def alphafold_train_loss(params, batch, cfg: AlphaFoldConfig, *,
                         generator: torch.Generator | None = None,
                         keeps: list[dict] | None = None,
                         n_recycle: int | None = None, remat: bool = True):
    """The training loss and its metrics, ``(loss, metrics)``. Dropout: the
    given ``keeps``, else masks drawn from ``generator``, else none (as the
    reference's rng=None). ``remat`` checkpoints each Evoformer block."""
    if keeps is None and generator is not None:
        keeps = draw_dropout_keeps(cfg, batch["msa"].shape, generator,
                                   batch["msa"].device)
    out = alphafold_forward(params, batch, cfg, n_recycle=n_recycle,
                            train=True, keeps=keeps, remat=remat)
    return alphafold_loss(out, batch)
