"""The contract matrix: (cell, ExecutionPlan preset) on a process group.

Each cell runs, on every rank of a gloo group, one program the port's
invariants were won on — the 2-block Evoformer stack under
``WholeModelDist`` (all four attention sites, forward and backward), the
fused triangle update (with its gradient) and outer-product-mean through
the DAP hooks, the reduced 2-block AlphaFold training-loss gradient, and the
paper-faithful DAP stack — records what it did (``contracts.RunArtifact``:
all-gather result shapes, collectives, peak memory) and evaluates the
contracts of ``analysis/contracts.py`` against the record.

The reference's ``dap_jaxpr`` cell folds into ``dap_stack``: an eager run
has one view of its collectives, the executed calls, where XLA had an HLO
view and a jaxpr view. Shapes are the reference's (those of the
distributed tests: small enough for CPU ranks in seconds, sharded the way
production is). The Evoformer cells run in bf16, the compute dtype AutoChunk
models; the triangle/OPM cell in fp32, as the reference's.

The peak is the rank's peak above what it held before the cell: on the CPU
the live bytes of the storages the run made
(``roofline.analysis.counting(memory=True)``), on the card, after an
uncounted warm-up run, the caching allocator's ``max_memory_allocated``
after ``reset_peak_memory_stats``, less what was allocated before. The
largest over the ranks is the cell's.
The per-cell ``PeakBytesWithin`` and ``CollectiveBudget`` limits bracket
the port's measured ratios and counts (in the comments), so a regression
that doubles a peak (a transient kept, a lost tiling) or halves it, that
doubles the collectives or drops a pass's, trips the gate.

On the card these widths lie outside the attention, triangle and OPM
kernels' envelopes, so the Evoformer's sites take their materialized
branches (LayerNorm, gating and softmax kernels; bias-dropout-add in the
training loss). The triangle/OPM cell calls the fused ops directly; where
a width lies outside a kernel's envelope on the run's device, it runs that
op's plain version (its leg set to "oracle"), as the Evoformer's sites would.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.analysis.contracts import (
    CollectiveBudget,
    CollectiveBytesWithin,
    NoMergedAllGather,
    PeakBytesWithin,
    RunArtifact,
    Violation,
    check_all,
)
from repro_torch.configs.alphafold import SMOKE, EvoformerConfig
from repro_torch.core import dist as D
from repro_torch.core.alphafold import init_alphafold
from repro_torch.core.dap import (block_collective_bytes, dap_evoformer_stack,
                                  shard_dap_inputs, whole_model_evoformer)
from repro_torch.core.evoformer import init_evoformer_stack
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.exec.plan import preset, use_plan
from repro_torch.kernels import _build, ops
from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.memory.autochunk import (modeled_evoformer_peak,
                                          opm_transient_bytes,
                                          triangle_transient_bytes)
from repro_torch.roofline.analysis import count_collective_ops, counting
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 randomize_tree)

# Evoformer cell config/shapes == the distributed suite's.
CFG = EvoformerConfig(d_msa=32, d_pair=16, msa_heads=4, pair_heads=2,
                      head_dim=8, opm_dim=8, tri_mult_dim=16, n_blocks=2)
B, S, R = 2, 8, 16
EVO_DTYPE = torch.bfloat16

# Per-cell PeakBytesWithin limits on peak/modeled, (lo, hi): the port's
# measured ratios, default / oracle preset, with about 2x room on each side
# (2 ranks; CPU: the live bytes ``counting`` records; card: the allocator
# after a warm-up, NVIDIA H100 80GB HBM3, 700 W). The model follows the
# branch each site takes: on the CPU the default plan's sites take the
# fused ops' plain versions, on the card (at these widths) the
# materialized branches, as the oracle plan does everywhere. The AutoChunk
# model is a dominant-term activation model of one block's forward: a
# backward holds more, and the AlphaFold loss runs the embedders,
# structure module and heads beside the Evoformer. A grad cell whose
# backward does nothing keeps the forward's saved tensors (ratio 6.19 on
# the CPU for evoformer_grad), inside its limits: the collective floor
# below is what catches it.
PEAK_LIMITS = {
    "evoformer_fwd": (0.4, 2.2),      # CPU 1.112 / 0.785, card 0.786 / 0.786
    "evoformer_grad": (3.2, 14.5),    # CPU 6.921 / 7.335, card 6.492 / 7.341
    "triangle_opm": (1.6, 6.6),       # CPU 3.389 / 3.268, card 3.295 / 3.295
    "alphafold_dryrun": (2.4, 11.0),  # CPU 5.551 / 5.175, card 4.932 / 5.299
    "dap_stack": (0.4, 2.2),          # CPU 1.105 / 0.779, card 0.780 / 0.780
}

# Per-cell CollectiveBudget limits, ops a block (every executed call
# divided by the cell's blocks), (min, max). The measured counts are equal
# on both presets and on both devices (the branches change no collective).
# The floor is what the program's passes must run: the forward's
# collectives, and in a grad cell the duals of what carries a gradient,
# so a backward that did nothing or a stack that ran unsharded trips it.
# The ceiling is under 2x the count, so a program that doubles its
# collectives trips it. DAP's Table III budget is 8 all-to-alls and 7
# all-gathers a block's forward; the whole-model cells add the stack's
# exit gathers, a backward the duals and the parameters' all-reduce.
COLLECTIVE_BUDGETS = {
    # measured 16: 8 all-to-all, 8 all-gather
    "evoformer_fwd": (16, 24),
    # measured 29: those 16, 6 + 6 duals, 1 all-reduce
    "evoformer_grad": (28, 44),
    # measured 9: 7 all-gather, 2 reduce-scatter (the duals)
    "triangle_opm": (9, 14),
    # measured 61: 48 in the forward (two recycling passes and the
    # backward's recompute), 6 + 6 duals, 1 all-reduce
    "alphafold_dryrun": (60, 92),
    # measured 15: 8 + 7, Table III
    "dap_stack": (15, 24),
}


@dataclass
class CellResult:
    """One rank's record of a cell: what ``RunArtifact`` needs, the
    contracts, the modeled bytes and the kernels launched."""

    name: str
    gathers: list
    log: dict
    blocks: int
    peak_bytes: int | None
    contracts: tuple
    modeled_bytes: int | None = None
    launches: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Inputs and measurement
# ---------------------------------------------------------------------------

def _randomized(tree, seed: int, device, dtype):
    """``tree``'s every leaf redrawn by ``weights.randomize_tree``."""
    drawn = randomize_tree(tree_map(lambda t: t.numpy(), tree), seed)
    return tree_map(lambda a: torch.as_tensor(a).to(device, dtype), drawn)


def _evo_params(device, dtype=EVO_DTYPE):
    return _randomized(init_evoformer_stack(torch.Generator().manual_seed(0),
                                            CFG), 0, device, dtype)


def _evo_inputs(device, dtype=EVO_DTYPE):
    g = torch.Generator().manual_seed(1)
    msa = torch.randn((B, S, R, CFG.d_msa), generator=g)
    pair = torch.randn((B, R, R, CFG.d_pair), generator=g)
    masks = (torch.ones(B, S, R), torch.ones(B, R), torch.ones(B, R, R))
    return (msa.to(device, dtype), pair.to(device, dtype),
            *(m.to(device) for m in masks))


def _measured(device, fn, exclude):
    """Run ``fn()`` on a fresh collective log; (its collectives, all-gather
    shapes, peak bytes above what was held before, launches). On the card
    ``fn`` runs once uncounted first: what a process allocates once (the
    cuBLAS workspace of each thread that multiplies, 32 MiB apiece: the
    forward's and the autograd engine's) is not the cell's."""
    if device.type == "cuda":
        fn()
    D.reset_collectives()
    _build.reset_launches()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        fn()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - before
    else:
        with counting(memory=True, exclude=exclude) as c:
            fn()
        peak = int(c.live_bytes().peak)
    return D.collectives(), D.collective_shapes(), peak, dict(_build.LAUNCHES)


def _fused_sites(device, dtype) -> dict:
    """Which branch each Evoformer site takes under the current plan at
    these widths (AutoChunk's ``fused`` axes)."""
    return dict(
        fused=ops.fused_attention_supported(
            (B, S, R, CFG.msa_heads, CFG.head_dim), kv_len=R, dtype=dtype,
            device=device),
        fused_triangle=ops.fused_triangle_supported(
            CFG.tri_mult_dim, CFG.d_pair, dtype, device),
        fused_opm=ops.fused_opm_supported(CFG.opm_dim, CFG.d_pair, dtype,
                                          device))


def _modeled(n: int, device) -> int:
    return modeled_evoformer_peak(CFG, batch=B, n_seq=S, n_res=R, dap=n,
                                  dtype=EVO_DTYPE,
                                  **_fused_sites(device, EVO_DTYPE))


# Legit rank-3+ all-gathers in these programs all lead with B (=2); a lead
# of B*S or B*R is the flatten-forced-gather signature.
_EVO_MERGED = frozenset({B * S, B * R})


def _evo_contracts(cell: str, modeled: int):
    return (NoMergedAllGather(_EVO_MERGED, min_rank=3),
            CollectiveBudget(*COLLECTIVE_BUDGETS[cell]),
            PeakBytesWithin(modeled, *PEAK_LIMITS[cell]))


# ---------------------------------------------------------------------------
# Cells: each runs on every rank; fn(pname, dist, device) -> [CellResult]
# ---------------------------------------------------------------------------

def cell_evoformer_fwd(pname: str, dist, device) -> list[CellResult]:
    """2-block Evoformer forward on whole tensors under ``WholeModelDist``
    (the reference's ``GspmdDist`` role): scatter at entry, the four
    attention sites, both triangle updates and the OPM under DAP, gather at
    exit."""
    params = _evo_params(device)
    inputs = _evo_inputs(device)

    def run():
        with torch.no_grad():
            whole_model_evoformer(params, *inputs, cfg=CFG, dist=dist)

    with use_plan(preset(pname)):
        log, gathers, peak, launches = _measured(device, run,
                                                 (params, inputs))
        modeled = _modeled(dist.axis_size, device)
    return [CellResult(f"evoformer_fwd/{pname}", gathers, log, CFG.n_blocks,
                       peak, _evo_contracts("evoformer_fwd", modeled),
                       modeled, launches)]


def cell_evoformer_grad(pname: str, dist, device) -> list[CellResult]:
    """The same stack's gradient of sum(msa²) + sum(pair²) with respect to
    every parameter: the backward's duals of each collective and the
    parameters' all-reduce."""
    params = _evo_params(device)
    inputs = _evo_inputs(device)

    def run():
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        m, z = whole_model_evoformer(live, *inputs, cfg=CFG, dist=dist)
        loss = m.float().square().sum() + z.float().square().sum()
        torch.autograd.grad(loss, tree_leaves(live))

    with use_plan(preset(pname)):
        log, gathers, peak, launches = _measured(device, run,
                                                 (params, inputs))
        modeled = _modeled(dist.axis_size, device)
    return [CellResult(f"evoformer_grad/{pname}", gathers, log, CFG.n_blocks,
                       peak, _evo_contracts("evoformer_grad", modeled),
                       modeled, launches)]


def cell_triangle_opm(pname: str, dist, device) -> list[CellResult]:
    """The fused triangle update (forward, then its gradient) and the fused
    OPM through the DAP hooks (``dist.sharded_triangle``,
    ``dist.sharded_opm``), as the Evoformer drives them: each rank holds its
    I/N rows (columns for the OPM), b is all-gathered, the output gathered
    whole. The three runs are one record, its peak the largest."""
    B2, I, K, C, D_, S2 = 2, 16, 16, 16, 12, 8
    c_opm = 8
    dt = torch.float32
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device, dt)

    a_lin, ga = rnd(B2, I, K, C), rnd(B2, I, K, C)
    mask = (torch.rand((B2, I, K), generator=g) < 0.7).to(device, dt)
    b_full, gamma, beta = rnd(B2, I, K, C), rnd(C), rnd(C)
    w_out, b_out = rnd(C, D_), rnd(D_)
    g_lin, g_bias = rnd(B2, I, I, D_), rnd(D_)
    oa, ob = rnd(B2, S2, I, c_opm), rnd(B2, S2, I, c_opm)
    oma = torch.ones(B2, S2, I, device=device)
    ow, obias = rnd(c_opm * c_opm, D_), rnd(D_)
    inputs = (a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
              g_bias, oa, ob, oma, ow, obias)

    def tri(a, b):
        b_g = dist.all_gather(dist.shard(b, axis=1), axis=1)
        out = dist.sharded_triangle(
            dist.shard(a, axis=1), dist.shard(ga, axis=1),
            dist.shard(mask, axis=1), b_g, gamma, beta, w_out, b_out,
            dist.shard(g_lin, axis=1), g_bias, tile=4)
        return dist.all_gather(out, axis=1)

    def opm():
        b_g = dist.all_gather(dist.shard(ob, axis=2), axis=2)
        mb = dist.all_gather(dist.shard(oma, axis=2), axis=2)
        out = dist.sharded_opm(dist.shard(oa, axis=2), b_g,
                               dist.shard(oma, axis=2), mb, ow, obias,
                               tile=4)
        return dist.all_gather(out, axis=1)

    def run():
        with torch.no_grad():
            tri(a_lin, b_full)
        a, b = (t.detach().requires_grad_(True) for t in (a_lin, b_full))
        torch.autograd.grad(tri(a, b).square().sum(), (a, b))
        with torch.no_grad():
            opm()

    plan = preset(pname)
    with use_plan(plan):
        fused_tri = ops.fused_triangle_supported(C, D_, dt, device)
        fused_opm = ops.fused_opm_supported(c_opm, D_, dt, device)
    if not fused_tri:
        plan = plan.with_kernels(triangle="oracle")
    if not fused_opm:
        plan = plan.with_kernels(opm="oracle")
    with use_plan(plan):
        log, gathers, peak, launches = _measured(device, run, inputs)
    n = dist.axis_size
    modeled = max(
        B2 * triangle_transient_bytes(I // n, K, C, tile=4, fused=fused_tri,
                                      dtype_bytes=4, d_out=D_),
        B2 * opm_transient_bytes(I // n, I, S2, c_opm, tile=4,
                                 fused=fused_opm, dtype_bytes=4, d_out=D_))
    contracts = (NoMergedAllGather(frozenset({B2 * I}), min_rank=3),
                 CollectiveBudget(*COLLECTIVE_BUDGETS["triangle_opm"]),
                 PeakBytesWithin(modeled, *PEAK_LIMITS["triangle_opm"]))
    return [CellResult(f"triangle_opm/{pname}", gathers, log, 1, peak,
                       contracts, modeled, launches)]


def cell_alphafold_dryrun(pname: str, dist, device) -> list[CellResult]:
    """Reduced 2-block AlphaFold training-loss gradient (SMOKE: embedders,
    recycling, the Evoformer under DAP, structure module, heads, dropout
    from a seeded generator) on the whole-model DAP plan."""
    ff = FastFold(SMOKE, device=device,
                  plan=preset(pname).with_parallel(backend="gspmd"))
    params = params_from_numpy(randomize_tree(params_to_numpy(
        init_alphafold(torch.Generator().manual_seed(0), SMOKE)), 0),
        device=device)
    batch = ff.batch_to_device(next(protein_batches(
        batch=B, n_seq=S, n_res=R, seed=0)).as_dict())

    def run():
        live = tree_map(lambda t: t.detach().requires_grad_(True)
                        if t.is_floating_point() else t, params)
        gen = torch.Generator(device=device).manual_seed(1)
        loss, _ = ff.train_loss(live, batch, gen)
        torch.autograd.grad(loss, [t for t in tree_leaves(live)
                                   if t.requires_grad], allow_unused=True)

    with use_plan(ff.plan):
        log, gathers, peak, launches = _measured(device, run,
                                                 (params, batch))
        modeled = modeled_evoformer_peak(
            SMOKE.evoformer, batch=B, n_seq=S, n_res=R, dap=dist.axis_size,
            dtype=SMOKE.compute_dtype, **_fused_sites(device,
                                                      SMOKE.compute_dtype))
    return [CellResult(f"alphafold_dryrun/{pname}", gathers, log,
                       SMOKE.evoformer.n_blocks, peak,
                       _evo_contracts("alphafold_dryrun", modeled), modeled,
                       launches)]


def cell_dap_stack(pname: str, dist, device) -> list[CellResult]:
    """Paper-faithful DAP stack (``dap.dap_evoformer_stack``) on sharded
    inputs, forward: besides the contracts above, each block's collectives
    are ``dap.block_collective_bytes``'s, call for call and byte for
    byte."""
    params = _evo_params(device)
    whole = _evo_inputs(device)
    n = dist.axis_size
    args = shard_dap_inputs(None, *whole)
    fn = dap_evoformer_stack(None, CFG, remat=False)

    def run():
        with torch.no_grad():
            fn(params, *args)

    with use_plan(preset(pname)):
        log, gathers, peak, launches = _measured(device, run,
                                                 (params, whole, args))
        modeled = _modeled(n, device)
    per_block = block_collective_bytes(CFG, batch=B, n_seq=S, n_res=R, n=n,
                                       dtype_bytes=2, mask_bytes=4)
    contracts = _evo_contracts("dap_stack", modeled) + (
        CollectiveBytesWithin(per_block, blocks=CFG.n_blocks),)
    return [CellResult(f"dap_stack/{pname}", gathers, log, CFG.n_blocks,
                       peak, contracts, modeled, launches)]


CELLS = (cell_evoformer_fwd, cell_evoformer_grad, cell_triangle_opm,
         cell_alphafold_dryrun, cell_dap_stack)
_BY_NAME = {c.__name__: c for c in CELLS}


def _rank_matrix(rank, world, init_file, preset_names, cell_names, device):
    """One rank of ``run_matrix``: every (preset, cell) in order."""
    dev = D.form_group(rank, world, init_file, backend="gloo", device=device)
    dist = D.WholeModelDist()
    out = []
    for pname in preset_names:
        for name in cell_names:
            out.extend(_BY_NAME[name](pname, dist, dev))
    D.reset_collectives()
    return out


def run_matrix(preset_names=("default", "oracle"), cells=CELLS, *,
               ranks: int = 2, device: str = "cpu",
               timeout_s: float = 900.0):
    """Run every cell under every preset on ``ranks`` gloo processes (one
    spawn for the whole matrix; on ``device``, "cpu" or "cuda", where ranks
    share the card) and evaluate the contracts. Returns (violations, rows):
    one row a cell and preset (modeled vs measured peak, collectives per
    block, kernel launches of rank 0, contract verdicts), in a stable
    order. The ranks must record the same collectives and gather shapes."""
    per_rank = D.run_ranks(_rank_matrix, ranks, list(preset_names),
                           [c.__name__ for c in cells], device,
                           timeout_s=timeout_s)
    violations, rows = [], []
    for recs in zip(*per_rank):
        res = recs[0]
        art = RunArtifact(
            res.name, res.gathers,
            max(r.peak_bytes for r in recs), count_collective_ops(
                res.log, res.blocks), res.log)
        v = check_all(res.contracts, art)
        if any(r.log != res.log or r.gathers != res.gathers for r in recs):
            v.append(Violation("RanksAgree", res.name,
                               "the ranks ran different collectives"))
        violations.extend(v)
        peak = art.peak_bytes
        rows.append({
            "cell": res.name,
            "preset": res.name.split("/")[1],
            "device": device,
            "ranks": ranks,
            "modeled_bytes": res.modeled_bytes,
            "peak_bytes": peak,
            "peak_bytes_by_rank": [r.peak_bytes for r in recs],
            "ratio": (round(peak / res.modeled_bytes, 3)
                      if peak and res.modeled_bytes else None),
            "collectives": dict(sorted(art.collective_counts.items())),
            "log": res.log,
            "launches": dict(sorted(res.launches.items())),
            "contracts": [c.name for c in res.contracts],
            "violations": [x.render() for x in v],
        })
    return violations, rows

