"""What each spawned rank of the port's DAP and TP tests runs
(``repro_torch.core.dist.run_ranks``): gloo groups on the CPU, the port
only (JAX runs in the parent test process alone). Every case takes numpy
inputs and returns numpy arrays and plain numbers for the parent to hold
against the reference."""
import numpy as np
import torch

from repro_torch.core import dist as D


def _np(t):
    return t.detach().float().numpy().copy()


def _group(rank, world, init_file):
    D.form_group(rank, world, init_file, backend="gloo", device="cpu",
                 timeout_s=120)
    return D.ProcessGroupDist()


def _shard(x: np.ndarray, axis: int, rank: int, n: int) -> torch.Tensor:
    size = x.shape[axis] // n
    return torch.as_tensor(np.take(x, range(rank * size, (rank + 1) * size),
                                   axis=axis).copy())


# ---------------------------------------------------------------------------
# test_torch_dist.py
# ---------------------------------------------------------------------------

# Each collective: the global input (x), the weights of the loss
# sum(w * out) (w), as the parent builds them from SEED; see
# ``collective_cases``.
SEED = 11
SHAPE = (2, 8, 12, 3)


def collective_inputs(n: int):
    """Global arrays: x, a weight w per rank (w[r]), and the sum of the
    ranks' own full inputs for the reduce-scatter (y[r])."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    w = rng.standard_normal((n,) + SHAPE).astype(np.float32)
    y = rng.standard_normal((n,) + SHAPE).astype(np.float32)
    return x, w, y


def dist_cases(rank, world, init_file):
    """``collective_cases`` and ``duality_cases`` on one group."""
    d = _group(rank, world, init_file)
    return collective_cases(d), duality_cases(d)


def collective_cases(d):
    """Forward and input gradient of every collective and Megatron op on
    the rank's tensors; loss = sum(w * out) with the rank's w laid out like
    out (its shard where out is a shard)."""
    rank, world = d.rank, d.axis_size
    D.reset_collectives()
    x, w, y = collective_inputs(world)
    res = {}

    def run(name, inp, op, w_out):
        t = inp.clone().requires_grad_(True)
        out = op(t)
        (out * w_out).sum().backward()
        res[name] = (_np(out), _np(t.grad))

    run("all_to_all", _shard(x, 1, rank, world),
        lambda t: d.all_to_all(t, split_axis=2, concat_axis=1),
        _shard(w[0], 2, rank, world))
    run("all_gather", _shard(x, 1, rank, world),
        lambda t: d.all_gather(t, axis=1), torch.as_tensor(w[rank]))
    run("psum_scatter", torch.as_tensor(y[rank]),
        lambda t: d.psum_scatter(t, axis=1), _shard(w[0], 1, rank, world))
    run("scatter", torch.as_tensor(x), lambda t: d.scatter(t, axis=1),
        _shard(w[0], 1, rank, world))
    run("gather", _shard(x, 1, rank, world), lambda t: d.gather(t, axis=1),
        torch.as_tensor(w[0]))
    run("all_reduce", torch.as_tensor(y[rank]), d.all_reduce,
        torch.as_tensor(w[0]))
    run("copy_to_ranks", torch.as_tensor(x), d.copy_to_ranks,
        torch.as_tensor(w[rank]))
    run("sync_grads", torch.as_tensor(x), lambda t: d.sync_grads([t])[0],
        torch.as_tensor(w[rank]))
    res["collectives"] = D.collectives()
    return res


def duality_cases(d):
    """Trigger/block against the synchronous collective (forward and input
    gradient), with the windows open and closed; and the event log of one
    DAP Evoformer block's forward and backward (checkpointed, as training
    runs it) under a recorder."""
    from repro_torch.core import duality
    from repro_torch.exec.plan import ExecutionPlan, use_plan

    rank, world = d.rank, d.axis_size
    x, w, _ = collective_inputs(world)
    res = {}
    kinds = {"all_gather": ({"axis": 1}, torch.as_tensor(w[rank])),
             "all_to_all": ({"split_axis": 2, "concat_axis": 1},
                            _shard(w[0], 2, rank, world))}
    for kind, (kw, w_out) in kinds.items():
        for how in ("sync", "open", "closed"):
            t = _shard(x, 1, rank, world).requires_grad_(True)
            if how == "sync":
                out = getattr(d, kind)(t, **kw)
            else:
                plan = ExecutionPlan().with_async(
                    overlap_windows=how == "open")
                with use_plan(plan):
                    h = duality.trigger(d, kind, t, **kw)
                    t.detach().mul(2.0).sum()     # compute in the window
                    out = duality.block(h)
            (out * w_out).sum().backward()
            res[f"{kind} {how}"] = (_np(out), _np(t.grad))
    res["block_log"] = _block_event_log(d)
    return res


def _block_event_log(d):
    from repro_torch.configs.alphafold import EvoformerConfig
    from repro_torch.core import duality
    from repro_torch.core.evoformer import evoformer_stack, init_evoformer_stack
    from repro_torch.layers.params import tree_leaves, tree_map

    cfg = EvoformerConfig(d_msa=32, d_pair=16, msa_heads=4, pair_heads=2,
                          head_dim=8, opm_dim=8, tri_mult_dim=16, n_blocks=1)
    g = torch.Generator().manual_seed(3)
    params = tree_map(lambda t: (0.3 * torch.randn(t.shape, generator=g))
                      .requires_grad_(True), init_evoformer_stack(g, cfg))
    n, rank = d.axis_size, d.rank
    b, s, r = 1, 4 * n, 4 * n
    msa = torch.randn((b, s // n, r, cfg.d_msa), generator=g,
                      requires_grad=True)
    pair = torch.randn((b, r // n, r, cfg.d_pair), generator=g,
                       requires_grad=True)
    masks = (torch.ones(b, s // n, r), torch.ones(b, r),
             torch.ones(b, r // n, r))
    with duality.use_recorder() as log:
        m, z = evoformer_stack(params, msa, pair, *masks, cfg=cfg, remat=True,
                               dist=d)
        (m.sin().sum() + z.sin().sum()).backward()
    assert all(t.grad is not None for t in tree_leaves(params))
    return log


# ---------------------------------------------------------------------------
# test_torch_dap.py
# ---------------------------------------------------------------------------

def _evo_params(tree, requires_grad=False):
    from repro_torch.weights import params_from_numpy

    params = params_from_numpy({"evoformer": tree}, device="cpu")["evoformer"]
    if requires_grad:
        for p in params:
            for leaf in _leaves(p):
                leaf.requires_grad_(True)
    return params


def _leaves(tree):
    from repro_torch.layers.params import tree_leaves

    return tree_leaves(tree)


def dap_stack_cases(rank, world, init_file, tree, feats, cfg_kw):
    """The port's DAP modules and stack on the rank's shards of ``feats``
    (msa, pair, msa_mask, seq_mask, pair_mask, whole numpy arrays): each
    module's output and the stack's, gathered; the stack's gradients of
    sum(sin(msa)) + sum(sin(pair)) (parameters synced, inputs gathered);
    the collectives of the stack's forward and backward (no remat)."""
    from repro_torch.configs.alphafold import EvoformerConfig
    from repro_torch.core import evoformer as E
    from repro_torch.core.dap import dap_evoformer_stack, shard_dap_inputs

    d = _group(rank, world, init_file)
    cfg = EvoformerConfig(**cfg_kw)
    msa, pair, msa_mask, seq_mask, pair_mask = (torch.as_tensor(f)
                                                for f in feats)
    params = _evo_params(tree)
    p = params[0]
    ms, zs, mms, sm, pms = shard_dap_inputs(None, msa, pair, msa_mask,
                                            seq_mask, pair_mask)
    m_r = d.shard(msa, axis=2)
    mm_r = d.shard(msa_mask, axis=2)
    res = {}
    with torch.no_grad():
        sites = {
            "msa_row": (lambda: E.msa_row_attention(
                p["msa_row"], ms, zs, sm, cfg, dist=d), 1),
            "msa_col": (lambda: E.msa_col_attention(
                p["msa_col"], m_r, mm_r, cfg, dist=d), 2),
            "opm": (lambda: E.outer_product_mean(
                p["opm"], m_r, mm_r, cfg, dist=d), 1),
            "tri_mult_out": (lambda: E.triangle_mult_outgoing(
                p["tri_mult_out"], zs, pms, cfg, dist=d), 1),
            "tri_mult_in": (lambda: E.triangle_mult_incoming(
                p["tri_mult_in"], E.transpose_pair(zs, d),
                E.transpose_pair(pms, d), cfg, dist=d), 1),
            "tri_attn_start": (lambda: E.triangle_attention(
                p["tri_attn_start"], zs, sm, cfg, dist=d), 1),
            "tri_attn_end": (lambda: E.transpose_pair(E.triangle_attention(
                p["tri_attn_end"], E.transpose_pair(zs, d), sm, cfg,
                dist=d), d), 1),
        }
        for site, (fn, axis) in sites.items():
            res[site] = _np(d.gather(fn(), axis=axis))
        stack = dap_evoformer_stack(None, cfg, remat=False)
        m, z = stack(params, ms, zs, mms, sm, pms)
        res["stack"] = (_np(d.gather(m, axis=1)), _np(d.gather(z, axis=1)))

    # Gradients, and the collectives of one forward and one backward.
    live = _evo_params(tree, requires_grad=True)
    ms_l, zs_l = ms.clone().requires_grad_(True), zs.clone().requires_grad_(True)
    D.reset_collectives()
    m, z = stack(live, ms_l, zs_l, mms, sm, pms)
    fwd = D.collectives()
    D.reset_collectives()
    (m.sin().sum() + z.sin().sum()).backward()
    res["collectives"] = {"forward": fwd, "backward": D.collectives()}
    res["param_grads"] = [_np(t.grad) for t in _leaves(live)]
    with torch.no_grad():
        res["input_grads"] = (_np(d.gather(ms_l.grad, axis=1)),
                              _np(d.gather(zs_l.grad, axis=1)))
    return res


def whole_model_cases(rank, world, init_file, tree, batch, steps_batches):
    """``FastFold(SMOKE)`` in fp32 under the whole-model DAP plan against
    the same facade with ``LocalDist``: the loss and every gradient with
    dropout off and with dropout on (masks from a generator seeded alike on
    every rank), and two AdamW steps with dropout; each rank's parameters
    and moments after them."""
    from repro_torch.configs import SMOKE
    from repro_torch.exec import ExecutionPlan, FastFold
    from repro_torch.layers.params import tree_map
    from repro_torch.train import make_train_step
    from repro_torch.weights import params_from_numpy

    _group(rank, world, init_file)
    plans = {"local": ExecutionPlan(),
             "dap": ExecutionPlan().with_parallel(backend="gspmd")}
    res = {}
    for name, plan in plans.items():
        ff = FastFold(SMOKE, device="cpu", dtype=torch.float32, plan=plan)
        for dropout in ("off", "on"):
            params = tree_map(lambda t: t.requires_grad_(True),
                              params_from_numpy(tree, device="cpu"))
            gen = (torch.Generator().manual_seed(5) if dropout == "on"
                   else None)
            loss, _ = ff.loss_fn(params, batch, gen)
            loss.backward()
            res[(name, dropout)] = (float(loss),
                                    [_np(t.grad) for t in _leaves(params)])
        init, step = make_train_step(ff.loss_fn, warmup_steps=1)
        state = init(params_from_numpy(tree, device="cpu"))
        gen = torch.Generator().manual_seed(6)
        for b in steps_batches:
            state, metrics = step(state, b, gen)
        res[(name, "steps")] = (
            float(metrics["loss"]),
            [_np(t) for t in _leaves(state.params)],
            [_np(t) for t in _leaves((state.opt_state.m, state.opt_state.v))])
    return res


# ---------------------------------------------------------------------------
# test_torch_tp.py
# ---------------------------------------------------------------------------

def tp_cases(rank, world, init_file, tree, feats, cfg_kw):
    """The port's TP stack on whole inputs: its output, the all-reduces of
    its forward, and the gradients of sum(sin(msa)) + sum(sin(pair)) (every
    rank computes the whole loss) with respect to every parameter and both
    inputs."""
    from repro_torch.configs.alphafold import EvoformerConfig
    from repro_torch.core.tp import tp_evoformer_stack

    _group(rank, world, init_file)
    cfg = EvoformerConfig(**cfg_kw)
    xs = [torch.as_tensor(f) for f in feats]
    fn = tp_evoformer_stack(None, cfg, remat=True)
    res = {}
    with torch.no_grad():
        D.reset_collectives()
        m, z = fn(_evo_params(tree), *xs)
        res["forward"] = (_np(m), _np(z))
        res["collectives"] = D.collectives()
    live = _evo_params(tree, requires_grad=True)
    msa, pair = (xs[0].clone().requires_grad_(True),
                 xs[1].clone().requires_grad_(True))
    m, z = fn(live, msa, pair, *xs[2:])
    (m.sin().sum() + z.sin().sum()).backward()
    res["param_grads"] = [_np(t.grad) for t in _leaves(live)]
    res["input_grads"] = (_np(msa.grad), _np(pair.grad))
    return res


def tp_refuses(rank, world, init_file, cfg_kw):
    """The ValueError a TP stack over this group raises, or None."""
    from repro_torch.configs.alphafold import EvoformerConfig
    from repro_torch.core.tp import tp_evoformer_stack

    _group(rank, world, init_file)
    try:
        tp_evoformer_stack(None, EvoformerConfig(**cfg_kw))
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# run_ranks itself
# ---------------------------------------------------------------------------

def fails_on_rank_one(rank, world, init_file):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def hangs_in_a_collective(rank, world, init_file):
    """Rank 0 waits in an all-gather that rank 1 never joins."""
    d = _group(rank, world, init_file)
    if rank == 0:
        d.all_gather(torch.zeros(4), axis=0)
    else:
        import time
        time.sleep(3600)


# ---------------------------------------------------------------------------
# test_torch_analysis.py
# ---------------------------------------------------------------------------

def merged_gather_control(rank, world, init_file):
    """The controls of the analysis contracts, on the port's collectives.
    A naive program that flattened (B, G) into one lead of B*G, sharded it
    and gathered the whole representation back, beside the right program
    that shards and gathers G; and the contract cells' DAP stack run once
    and twice (a stack that doubles its collectives); and the evoformer_grad
    cell with ``torch.autograd.grad`` a no-op (a backward that does
    nothing). Returns the all-gather shapes of each program, the stack's
    logs and the grad cell's record."""
    from repro_torch.analysis import cells
    from repro_torch.core.dap import dap_evoformer_stack, shard_dap_inputs

    d = _group(rank, world, init_file)
    b, g, s, dm = 2, 8, 16, 8
    x = torch.randn((b, g, s, dm), generator=torch.Generator().manual_seed(0))
    out = {}
    D.reset_collectives()
    merged = x.reshape(b * g, s, dm)
    d.all_gather(d.shard(merged, axis=0) * 2.0, axis=0)
    out["naive"] = D.collective_shapes()
    D.reset_collectives()
    d.all_gather(d.shard(x, axis=1) * 2.0, axis=1)
    out["sharded_g"] = D.collective_shapes()

    params = cells._evo_params("cpu")
    args = shard_dap_inputs(None, *cells._evo_inputs("cpu"))
    fn = dap_evoformer_stack(None, cells.CFG, remat=False)
    for times in (1, 2):
        D.reset_collectives()
        with torch.no_grad():
            for _ in range(times):
                fn(params, *args)
        out[f"stack x{times}"] = D.collectives()

    grad = torch.autograd.grad
    torch.autograd.grad = lambda *args, **kwargs: None
    try:
        out["grad without backward"], = cells.cell_evoformer_grad(
            "default", D.WholeModelDist(), torch.device("cpu"))
    finally:
        torch.autograd.grad = grad
    D.reset_collectives()
    return out
