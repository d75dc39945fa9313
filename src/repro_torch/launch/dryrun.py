"""Dry-run without devices: every (architecture x input shape), on the
(32, 8) and (2, 32, 8) production meshes of H100s, plus AlphaFold itself
(Initial Training and Fine-tuning under DAP), each as one record of what
one device would hold and do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--include-alphafold] [--out f.json]

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each step on 512 fake TPU devices and reads its memory
and cost from XLA. PyTorch compiles nothing, so each record is taken from
the per-device program as it runs on fake tensors
(``torch._subclasses.FakeTensorMode``: shapes and dtypes, no storage), on
the CPU, under ``roofline.analysis.counting`` with its memory tracker. It
launches no kernel and uses no card, as the reference uses no TPU.

Each record's terms and where they come from:

* ``memory.state_bytes``: parameters, optimizer state, caches and inputs,
  each leaf's bytes under the plan's specs (``parallel.plan``), exactly.
* ``memory.activation_bytes``: the peak of the bytes the program allocates
  on top of its state (the tracker), each storage weighted by the share of
  it a device holds, by what it stands for (``_weigh``): a parameter's
  gradient, and what the step makes of the gradients and the parameters
  after the backward, by that parameter's own spec; the new moments, and
  what the update makes of the old ones, by the m/v spec; anything else
  made before the backward ends, an activation, by the sequence shards
  (below). A storage is known by identity, not by shape: the gradients
  as autograd hands them to the parameters' hooks, the state's leaves as
  given, the rest by the first of its op's inputs with its element count
  (``Counter.tag``). ``counted.gradient_bytes`` is what a device holds as
  the backward ends, ``counted.output_bytes`` what it holds of the
  program's output (a step's new state).
* ``roofline``: the counted FLOPs and HBM bytes of one device, and the
  bytes it sends in collectives, against one H100's constants
  (``launch.mesh``); ``collectives`` the calls and bytes by kind.

The per-device program. AlphaFold runs the port's own DAP path
(``core.dist.WholeModelDist``) on a fake process group of the model axis's
size, rank 0 of it, at the per-device batch: its shards and collectives are
the program's own (``core.dist.collectives()``). The decoders: the port's
decoder is one device's program, with no sequence-parallel attention (the
reference's GSPMD inserts one). So for train and prefill, whose sequence
the ``model`` axis shards, the dry-run runs the model-axis group's program
(the per-device batch, the whole sequence) and charges each of its m
devices 1/m of its FLOPs, bytes and activations, and adds the collectives
the plan implies: every sharded parameter all-gathered at each use (twice
in a step: the forward and the per-layer recompute), every gradient
reduce-scattered to its m/v shard and the replicated parameters gathered
back, and each attention layer's K and V all-gathered over the model axis
(in a step: forward and recompute, and their gradients reduce-scattered).
Decode runs the per-device program itself: the per-device batch against
its shard of the cache's rows, the weights gathered as for prefill.

Depth: the reference scales its layer scan by its trip count. The dry-run
runs a few layers (``_depth_runs``: each run adds one layer of one kind)
and extrapolates each count (FLOPs, bytes, collectives, peak) linearly to
the configuration's depth; AlphaFold likewise over Evoformer blocks (1 and
2). The layers of a kind are one program at one shape, so FLOPs and bytes
are exact; the peak is exact where each layer adds what the one before
added (a checkpointed layer's input, a layer's cache). Fake tensors still
cost each op its dispatch, so a recurrence stepped token by token (sLSTM,
Mamba) at 32k tokens takes minutes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import time
import traceback

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     link_bw, make_production_mesh)
from repro_torch.parallel import plan
from repro_torch.roofline import analysis

HBM_KEY = "fits_h100_80gb"


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: long_500k requires a sub-quadratic "
                "path (DESIGN.md §Arch-applicability)")
    return None


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Text tokens; VLM prefix tokens count toward the sequence budget."""
    if cfg.modality and cfg.modality.n_prefix_tokens and shape.kind != "decode":
        return shape.seq_len - cfg.modality.n_prefix_tokens
    return shape.seq_len


# ---------------------------------------------------------------------------
# fake tensors and a fake process group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group as a fake one of ``world_size`` ranks (this
    process rank 0; its collectives move nothing), destroyed on exit, also
    when the body raises."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if tdist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised")
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world_size)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _fake_like(tree):
    """Fake CPU tensors of ``tree``'s shapes and dtypes (call inside the
    fake mode)."""
    from repro_torch.layers.params import tree_map

    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _meta(fn, *args):
    with torch.device("meta"):
        return fn(*args)


# ---------------------------------------------------------------------------
# one counted run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """The counts of one run of a program at one depth."""
    flops: float
    hbm_bytes: float
    memory: analysis.Memory = analysis.Memory(0.0, 0.0, 0.0)
    collectives: dict = dataclasses.field(default_factory=dict)

    def __sub__(self, o):
        return self.scaled(-1, o)

    def scaled(self, k: float, extra: "Run") -> "Run":
        """self + k * extra."""
        return Run(self.flops + k * extra.flops,
                   self.hbm_bytes + k * extra.hbm_bytes,
                   analysis.Memory(*(a + k * b for a, b in zip(
                       self.memory, extra.memory))),
                   _coll_add(self.collectives, extra.collectives, k))


def _coll_add(a: dict, b: dict, k: float) -> dict:
    out = {kind: {p: dict(v) for p, v in ps.items()} for kind, ps in a.items()}
    for kind, ps in b.items():
        for p, v in ps.items():
            row = out.setdefault(kind, {}).setdefault(p, {"calls": 0,
                                                          "bytes": 0})
            row["calls"] += k * v["calls"]
            row["bytes"] += k * v["bytes"]
    return out


def _counted(program, inputs, keys, weigh) -> Run:
    """Run ``program()`` once under counting. ``inputs`` are left out of
    the memory (their bytes are the record's state, from the specs); the
    leaves of a ``TrainState`` among them are tagged ("p", key), ("m",
    key) and ("v", key), ``keys`` their parameters' keys (``_keys``)."""
    from repro_torch.core import dist
    from repro_torch.train.state import TrainState

    dist.reset_collectives()
    with analysis.counting(memory=True, exclude=inputs) as c:
        for tree in inputs:
            if isinstance(tree, TrainState):
                for kind, leaves in (("p", tree.params),
                                     ("m", tree.opt_state.m),
                                     ("v", tree.opt_state.v)):
                    for key, t in zip(keys, plan._leaves(leaves)):
                        c.tag(t, (kind, key))
        out = program()
    # ``out`` alive through the replay: its bytes are ``at_end``'s.
    run = Run(c.flops, c.hbm_bytes, c.live_bytes(weigh), dist.collectives())
    del out
    return run


def _keys(params, cfg: ModelConfig | None = None) -> list:
    """Each parameter's key, in ``plan._leaves`` order: its path with a
    stack's layer index left out (``plan._map``) and a decoder stage's
    index replaced by its kind, so that a depth run's leaves and those of
    the configuration it stands for share keys."""
    kinds = [k for k, _ in cfg.resolved_stages] if cfg is not None else []

    def key(path, leaf, stack):
        parts = path.split("/")
        if kinds and parts[0] == "stages":
            parts[1] = kinds[int(parts[1])]
        return "/".join(parts)
    return list(plan._leaves(plan._map(key, params)))


def _shares(params, specs, mesh, cfg: ModelConfig | None = None) -> dict:
    """{key: the share of a leaf one device holds under ``specs``}, the
    mean over the leaves of one key (the layers of a kind)."""
    sums: dict = {}
    for key, spec in zip(_keys(params, cfg), plan._spec_leaves(specs)):
        row = sums.setdefault(key, [0.0, 0])
        row[0] += 1.0 / _shards(spec, mesh)
        row[1] += 1
    return {key: total / n for key, (total, n) in sums.items()}


def _tag_grads(loss_fn, keys):
    """``loss_fn`` with each parameter's gradient tagged ("grad", key) as
    autograd hands it over (``keys`` as ``_counted`` takes them)."""
    def loss(params, batch, rng):
        c = analysis.active()
        for key, p in zip(keys, plan._leaves(params)):
            if p.requires_grad:
                p.register_hook(functools.partial(_tag, c, ("grad", key)))
        return loss_fn(params, batch, rng)
    return loss


def _tag(counter, tag, grad):
    counter.tag(grad, tag)


def _weigh(p_shares: dict, mv_shares: dict, act_share: float):
    """``Counter.live_bytes``'s weight: the share of a storage one device
    holds, by what its tag says it stands for (module doc), from the
    configuration's ``_shares`` of its parameters and of its moments.
    After the backward, an untagged storage (a norm, a flag) is held
    whole."""
    def weigh(tag, after_backward):
        kind, key = tag if tag is not None else (None, None)
        if kind == "grad" or (after_backward and kind == "p"):
            return p_shares[key]
        if after_backward and kind in ("m", "v"):
            return mv_shares[key]
        return 1.0 if after_backward else act_share
    return weigh


def _shards(spec, mesh) -> int:
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _kinds(cfg: ModelConfig) -> dict[str, int]:
    """Each layer kind and its count over the stages, in order."""
    out: dict[str, int] = {}
    for kind, count in cfg.resolved_stages:
        out[kind] = out.get(kind, 0) + count
    return out


def _with_counts(cfg: ModelConfig, counts: dict) -> ModelConfig:
    stages = tuple((k, c) for k, c in counts.items() if c)
    return dataclasses.replace(cfg, stages=stages,
                               n_layers=sum(c for _, c in stages))


# Layer kinds by the ops their per-token loops run under fake tensors: the
# cheaper ones are run first, so the dearest runs once (below).
_LOOPS = {"mlstm": 1, "hymba": 2, "hymba_full": 2, "slstm": 3}


def _depth_runs(cfg: ModelConfig, measure) -> tuple[Run, list]:
    """``measure(cfg)`` extrapolated to ``cfg``'s depth from a few runs:
    one layer of the cheapest kind, then two of it, then each other kind
    added in turn with one layer. Each run's difference from the one before
    is one layer of the kind it added (for the first kind, its second
    layer, so that a layer's part of the peak is what it keeps, not the
    transient one layer's backward makes)."""
    kinds = _kinds(cfg)
    order = sorted(kinds, key=lambda k: _LOOPS.get(k.partition("+")[0], 0))
    counts = {order[0]: 1}
    base = measure(_with_counts(cfg, counts))
    depths, deltas = [dict(counts)], {}
    if kinds[order[0]] > 1:
        depths.append({order[0]: 2})
        deltas[order[0]] = measure(_with_counts(cfg, depths[-1])) - base
    for kind in order[1:]:
        counts[kind] = 1
        depths.append(dict(counts))
        more = measure(_with_counts(cfg, counts))
        deltas[kind], base = more - base, more
    total = base
    for kind, delta in deltas.items():
        total = total.scaled(kinds[kind] - 1, delta)
    return total, depths


def _attn_rows(cfg: ModelConfig, s: int) -> dict[str, tuple[int, int]]:
    """Per attention-bearing layer kind: (layers, K and V elements a token
    keeps) — the rows a sequence shard gathers from the others."""
    hd = cfg.resolved_head_dim
    out = {}
    for kind, count in _kinds(cfg).items():
        mixer = kind.partition("+")[0]
        if mixer in ("attn", "hymba_full"):
            out[kind] = (count, s, 2 * cfg.n_kv * hd)
        elif mixer in ("swa", "hymba"):
            out[kind] = (count, min(s, cfg.sliding_window), 2 * cfg.n_kv * hd)
        elif mixer == "mla":
            out[kind] = (count, s, cfg.mla.kv_lora + cfg.mla.rope_dim)
    return out


def _implied_collectives(cfg, shape, mesh, params, p_specs, b: int,
                         dtype_bytes: int) -> dict:
    """{axis group: {kind: {"calls", "bytes"}}} the plan implies for one
    device (module doc): parameter gathers, gradient reductions and, under
    sequence sharding, the K/V gathers."""
    m = mesh.shape["model"]
    uses = 2 if shape.kind == "train" else 1
    out: dict = {}

    def add(axes, kind, calls, nbytes):
        key = "model" if set(axes) <= {"model"} else "data"
        row = out.setdefault(key, {}).setdefault(kind, {"calls": 0,
                                                        "bytes": 0})
        row["calls"] += calls
        row["bytes"] += nbytes

    for leaf, ps in zip(plan._leaves(params), plan._spec_leaves(p_specs)):
        full = leaf.numel() * (4 if shape.kind == "train" else dtype_bytes)
        n = _shards(ps, mesh)
        if n > 1:
            add(_axes(ps), "all_gather", uses, uses * full * (n - 1) / n)
        if shape.kind == "train":
            # every device's partial gradient summed onto its m/v shard, and
            # the updated shard gathered back where the parameter is whole
            k = mesh.size
            add(mesh.axis_names, "reduce_scatter", 1, full * (k - 1) / k)
            if n == 1:
                add(mesh.axis_names, "all_gather", 1, full * (k - 1) / k)
    if shape.kind != "decode" and m > 1:
        for layers, rows, width in _attn_rows(cfg, shape.seq_len).values():
            kv = b * rows * width * dtype_bytes
            calls = layers * (3 if shape.kind == "train" else 1)
            add(("model",), "all_gather", calls, calls * kv * (m - 1) / m)
    return out


def _axes(spec) -> tuple:
    names = []
    for entry in spec:
        if entry is not None:
            names += [entry] if isinstance(entry, str) else list(entry)
    return tuple(names)


def _lm_program(cfg: ModelConfig, shape: ShapeConfig, b: int, rows: int):
    """(program, inputs, keys) of one decoder call on fake tensors (keys
    for ``_counted``, None but for a step): a train step at
    (b, text) tokens, a prefill, or a decode step against ``rows`` cache
    rows."""
    from repro_torch.models.decoder import (init_cache, init_model, lm_loss,
                                            model_forward)
    from repro_torch.train.loop import make_train_step

    skeleton = _meta(init_model, None, cfg)
    s = text_len(cfg, shape)
    prefix = None
    if cfg.modality and cfg.modality.n_prefix_tokens and shape.kind != "decode":
        prefix = torch.empty((b, cfg.modality.n_prefix_tokens, cfg.d_model),
                             dtype=torch.bfloat16)
    if shape.kind == "train":
        keys = _keys(skeleton, cfg)
        init_state, step = make_train_step(
            _tag_grads(lambda p, batch, rng: lm_loss(p, batch, cfg), keys),
            base_lr=3e-4,
            total_steps=10_000, weight_decay=0.1,
            state_dtype=torch.bfloat16 if cfg.opt_state_bf16 else torch.float32)
        state = init_state(_fake_like(skeleton))
        batch = {"tokens": torch.empty((b, s), dtype=torch.long),
                 "targets": torch.empty((b, s), dtype=torch.long),
                 "mask": torch.empty((b, s))}
        if prefix is not None:
            batch["prefix_embeds"] = prefix
        return (lambda: step(state, batch, None)), (state, batch), keys
    params = _fake_like(_meta(_bf16, skeleton))
    if shape.kind == "prefill":
        tokens = torch.empty((b, s), dtype=torch.long)

        def prefill():
            with torch.no_grad():
                return model_forward(params, tokens, cfg, mode="prefill",
                                     prefix_embeds=prefix,
                                     max_cache_len=shape.seq_len)
        return prefill, (params, tokens), None
    cache = init_cache(cfg, b, rows)
    tokens = torch.empty((b, 1), dtype=torch.long)
    lengths = torch.zeros((b,), dtype=torch.long)

    def decode():
        with torch.no_grad():
            return model_forward(params, tokens, cfg, mode="decode",
                                 cache=cache, lengths=lengths)
    return decode, (params, tokens, cache, lengths), None


def _bf16(tree):
    from repro_torch.layers.params import cast_tree

    return cast_tree(tree, torch.bfloat16)


def _batch_size(mesh) -> int:
    n = 1
    for a in plan.batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _run_lm(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    from repro_torch.layers.params import count_params
    from repro_torch.models.decoder import init_cache, init_model
    from repro_torch.train.loop import make_train_step

    cfg = plan.moe_with_groups(cfg, mesh)
    gb = shape.global_batch
    b = max(1, gb // _batch_size(mesh)) if gb > 1 else 1
    seq_shards = _shards((plan.seq_axes(mesh, shape),), mesh)
    skeleton = _meta(init_model, None, cfg)
    if shape.kind == "train":
        p_specs = plan.model_param_specs(skeleton, mesh)
        init_state, _ = make_train_step(
            lambda *a: None, state_dtype=torch.bfloat16
            if cfg.opt_state_bf16 else torch.float32)
        state = _meta(init_state, skeleton)
        state_specs = plan.train_state_specs(state, mesh, p_specs)
        mv_specs = state_specs.opt_state.m
        state_bytes = plan.device_bytes(state, state_specs, mesh)
        params = skeleton
    else:
        params = _meta(_bf16, skeleton)
        p_specs = plan.model_param_specs(
            params, mesh,
            force_shard=False if cfg.serve_replicate_params else None)
        mv_specs = plan.tree_param_specs(params, mesh)
        cache = _meta(init_cache, cfg, b * _batch_size(mesh) if gb > 1 else 1,
                      shape.seq_len)
        c_specs = plan.cache_specs(cache, mesh, shape, cfg)
        state_bytes = (plan.device_bytes(params, p_specs, mesh)
                       + plan.device_bytes(cache, c_specs, mesh))
    # Inputs: the token ids (and a prefix) per the token spec.
    tok = b * (1 if shape.kind == "decode" else
               text_len(cfg, shape) // seq_shards) * 8
    state_bytes += tok * (2 if shape.kind == "train" else 1)
    share = 1.0 if shape.kind == "decode" else 1.0 / seq_shards
    weigh = _weigh(_shares(params, p_specs, mesh, cfg),
                   _shares(params, mv_specs, mesh, cfg), share)
    rows = shape.seq_len // seq_shards

    def measure(c):
        with _fake_mode():
            return _counted(*_lm_program(c, shape, b, rows), weigh)

    run, depths = _depth_runs(cfg, measure)
    coll = _implied_collectives(cfg, shape, mesh, params, p_specs, b, 2)
    n_params = count_params(skeleton)
    return _record(run.flops * share, run.hbm_bytes * share,
                   state_bytes, run.memory, coll, mesh, depths,
                   {"per_device_batch": b, "sequence_shards": seq_shards,
                    "cache_rows": rows if shape.kind == "decode" else None,
                    "params": n_params,
                    "model_flops_per_device": analysis.model_flops(
                        shape, n_params) / mesh.size})


# ---------------------------------------------------------------------------
# AlphaFold (the paper's own model) under DAP
# ---------------------------------------------------------------------------

def _af_batch(b: int, s: int, r: int) -> dict:
    """Fake features of one per-device batch, dtypes as ``protein_batches``
    gives them."""
    from repro_torch.data import protein_batches

    tiny = next(protein_batches(batch=1, n_seq=2, n_res=3, seed=0)).as_dict()
    shapes = {"msa": (b, s, r), "msa_mask": (b, s, r),
              "residue_index": (b, r), "aatype": (b, r), "seq_mask": (b, r),
              "pseudo_beta": (b, r, 3), "bert_mask": (b, s, r),
              "true_msa": (b, s, r)}
    return {k: torch.empty(shp, dtype=torch.as_tensor(tiny[k]).dtype)
            for k, shp in shapes.items()}


def _run_alphafold(variant: str, mesh, evo_overrides: dict | None) -> dict:
    from repro_torch.configs import alphafold as afc
    from repro_torch.core.alphafold import init_alphafold
    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import ExecutionPlan
    from repro_torch.train.loop import make_train_step

    cfg = afc.FULL
    if evo_overrides:
        cfg = dataclasses.replace(
            cfg, evoformer=dataclasses.replace(cfg.evoformer, **evo_overrides))
    dims = afc.INITIAL_TRAINING if variant == "initial" else afc.FINE_TUNING
    m = mesh.shape["model"]
    b = max(1, dims["batch"] // _batch_size(mesh))
    s, r = dims["n_seq"], dims["n_res"]
    gen = torch.Generator()

    def state_of(c):
        init_state, _ = make_train_step(lambda *a: None, base_lr=1e-3,
                                        total_steps=10_000)
        return _meta(lambda: init_state(init_alphafold(gen, c)))

    # paper-faithful DAP: params fully replicated; ZeRO-1 on optimizer m/v
    state = state_of(cfg)
    state_specs = plan.train_state_specs(state, mesh,
                                         plan.tree_replicated(state.params))
    state_bytes = plan.device_bytes(state, state_specs, mesh)
    weigh = _weigh(_shares(state.params, state_specs.params, mesh),
                   _shares(state.params, state_specs.opt_state.m, mesh), 1.0)
    run_plan = ExecutionPlan().with_parallel(backend="gspmd").with_memory(
        hbm_budget=HBM_BYTES)

    def measure(n_blocks):
        c = dataclasses.replace(cfg, evoformer=dataclasses.replace(
            cfg.evoformer, n_blocks=n_blocks))
        skeleton = state_of(c)
        with _fake_mode():
            ff = FastFold(c, device="cpu", plan=run_plan)
            keys = _keys(skeleton.params)
            _, step = make_train_step(_tag_grads(ff.loss_fn, keys),
                                      base_lr=1e-3,
                                      total_steps=10_000)
            st = _fake_like(skeleton)
            st = type(skeleton)(*st[:2], type(skeleton.opt_state)(*st[2]))
            batch = _af_batch(b, s, r)
            return _counted(lambda: step(st, batch, None), (st, batch),
                            keys, weigh)

    with fake_group(m):
        one = measure(1)
        two = measure(2)
    run = one.scaled(cfg.evoformer.n_blocks - 1, two - one)
    coll = {"model": {kind: {"calls": sum(v["calls"] for v in ps.values()),
                             "bytes": sum(v["bytes"] for v in ps.values())}
                      for kind, ps in _without_halves(run.collectives)}}
    per_block = analysis.collective_stats((two - one).collectives, m)
    return _record(run.flops, run.hbm_bytes, state_bytes, run.memory, coll,
                   mesh, [{"n_blocks": 1}, {"n_blocks": 2}],
                   {"per_device_batch": b, "n_seq": s, "n_res": r,
                    "dap_ranks": m,
                    "collectives_per_block": {
                        "counts": per_block.counts,
                        "wire_bytes": per_block.wire_bytes}})


def _without_halves(log: dict):
    """(kind, {pass: counts}) of ``core.dist``'s log, an all-reduce's two
    halves left out (it counts once as itself)."""
    for kind, ps in log.items():
        ps = {p: v for p, v in ps.items() if p != analysis._HALVES}
        if ps:
            yield kind, ps


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def _record(flops, hbm_bytes, state_bytes, memory, coll, mesh, depths,
            extra) -> dict:
    wire, t_link = 0.0, 0.0
    counts, payload = {}, {}
    for group, kinds in coll.items():
        bw = link_bw(mesh, "model" if group == "model" else "data")
        for kind, v in kinds.items():
            op = analysis._KIND[kind]
            wire += v["bytes"]
            t_link += v["bytes"] / bw
            counts[op] = counts.get(op, 0) + v["calls"]
            payload[op] = payload.get(op, 0.0) + v["bytes"]
    roof = analysis.Roofline(
        flops=flops, hbm_bytes=hbm_bytes, wire_bytes=wire, chips=1,
        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
        ici_bw=wire / t_link if t_link else link_bw(mesh, "model"))
    act_bytes = memory.peak
    per_dev = state_bytes + act_bytes
    return {
        "status": "ok",
        "memory": {"state_bytes": int(state_bytes),
                   "activation_bytes": int(act_bytes),
                   "per_device_bytes": int(per_dev),
                   "hbm_bytes": HBM_BYTES,
                   HBM_KEY: bool(per_dev <= HBM_BYTES)},
        "collectives": {"counts": counts, "wire_bytes_by_kind": payload,
                        "wire_bytes": wire, "link_bw": roof.ici_bw},
        "roofline": roof.as_dict(),
        "counted": {"depths": depths,
                    "gradient_bytes": int(memory.at_backward_end),
                    "output_bytes": int(memory.at_end), **extra},
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            overrides: dict | None = None, mesh=None,
            shape: ShapeConfig | None = None) -> dict:
    """One record. ``mesh`` (a ``launch.mesh.MeshShape``) replaces the
    production mesh and ``shape`` the named input shape where given."""
    t0 = time.time()
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape.name if shape else shape_name,
           "chips": mesh.size, "mesh": str(mesh),
           "overrides": overrides or {}}
    if arch.startswith("alphafold"):
        rec.update(_run_alphafold(arch.split("-")[1], mesh, overrides))
    else:
        cfg = get_config(arch)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        shape = shape or INPUT_SHAPES[shape_name]
        skip = skip_reason(cfg, shape)
        if skip:
            rec.update({"status": "skipped", "reason": skip})
            return rec
        rec.update(_run_lm(cfg, shape, mesh))
    rec["run_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--include-alphafold", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    jobs = []
    if args.all:
        for arch in list_archs():
            for shape in INPUT_SHAPES:
                jobs.append((arch, shape))
        if args.include_alphafold:
            jobs += [("alphafold-initial", "train"),
                     ("alphafold-finetune", "train")]
    else:
        jobs = [(args.arch, args.shape)]

    results = []
    for arch, shape in jobs:
        try:
            rec = run_one(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:  # a failure here is a bug in the system
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f"bottleneck={r['bottleneck']} "
                     f"tc={r['t_compute_s']:.2e} tm={r['t_memory_s']:.2e} "
                     f"tx={r['t_collective_s']:.2e} "
                     f"mem={rec['memory']['per_device_bytes'] / 1e9:.1f}GB "
                     f"fits={rec['memory'][HBM_KEY]}")
        elif status == "error":
            extra = rec["error"][:160]
        print(f"[{status:7s}] {arch:24s} {shape:12s} {extra}", flush=True)
        results.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
