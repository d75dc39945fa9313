"""Training step factory: loss -> gradients (the model's compute dtype, fp32
master weights) -> global-norm clip -> learning-rate schedule -> optimizer
-> new state. The port of the reference's ``make_train_step``, with its
gradient accumulation (micro-batching) and its non-finite guard.

``guard_nonfinite`` (default on) discards the parameter and optimizer update
whenever the global gradient norm is not finite: gradients are zeroed before
the optimizer sees them and the old state is selected leafwise, so a healthy
step is bit-identical with the guard on or off. A skipped step still
advances ``state.step`` and reports ``nonfinite_skips = 1``. The selects of
parameters and moments stay on the device; the optimizer's step count lives
on the CPU, so selecting it waits for the gradient norm once per step: the
step's one synchronise, queued after the parameters' selects and before the
moments', so the host waits there for the whole step's device work queued
so far.

Spans (``repro_torch.obs``; no-ops with no tracer scoped): ``train.step``
around a step, inside it ``train.forward`` (the loss), ``train.backward``
(``torch.autograd.grad`` and the zero fill of unused leaves),
``train.clip`` and ``train.optimizer`` (the guard's zeroing, the schedule,
the update and the leafwise selects), which holds ``train.wait``: the
guard's device-to-host copy of ``ok``.

``instrument_train_step`` wraps a step so that each call emits one obs
``train_step`` event when a tracer is scoped, and is the bare call when none
is.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.obs import trace as obs
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.state import TrainState, make_train_state


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_train_step(
    loss_fn: Callable,          # (params, batch, rng) -> (loss, metrics)
    *,
    optimizer: str = "adamw",
    base_lr: float = 1e-3,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.0,
    clip_norm: float = 1.0,
    accum_steps: int = 1,
    state_dtype=torch.float32,
    guard_nonfinite: bool = True,
):
    """Returns ``(init_state, train_step)``. ``rng`` is what ``loss_fn``
    takes for dropout: for ``FastFold.loss_fn`` a ``torch.Generator`` or
    None (no dropout)."""
    opt_init_raw, opt_update = make_optimizer(optimizer)
    opt_init = partial(opt_init_raw, state_dtype=state_dtype)

    def init_state(params) -> TrainState:
        return make_train_state(params, opt_init)

    n_leaves = []       # the parameters' leaf count, found at first call

    def compute_grads(params, batch, rng):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with obs.span("train.forward"):
            loss, metrics = loss_fn(live, batch, rng)
        with obs.span("train.backward"):
            leaves = tree_leaves(live)
            grads = iter(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
            grads = tree_map(lambda p: _or_zeros(next(grads), p), live)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch, rng=None):
        """One optimizer step: ``(state, batch, rng) -> (state, metrics)``.

        Every key below is present on every step:
            loss             training loss (micro-batch mean under
                             gradient accumulation)
            grad_norm        global L2 norm of the gradients before clipping
            lr               this step's scheduled learning rate
            nonfinite_skips  1.0 when the guard discarded the update, else 0.0
        plus the loss's own metrics.
        """
        if not n_leaves:
            n_leaves.append(len(tree_leaves(state.params)))
        with obs.span("train.step", leaves=n_leaves[0]):
            return step_body(state, batch, rng)

    def step_body(state: TrainState, batch, rng):
        if accum_steps == 1:
            loss, metrics, grads = compute_grads(state.params, batch, rng)
        else:
            # Micro-batching: the batch's leading dim must divide by
            # accum_steps. Each micro-batch draws its own dropout masks from
            # the same generator (the reference folds the step into its rng).
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            loss_sum = 0.0
            for i in range(accum_steps):
                mb = {k: x[i * (x.shape[0] // accum_steps):
                           (i + 1) * (x.shape[0] // accum_steps)]
                      for k, x in batch.items()}
                loss_i, _, g_i = compute_grads(state.params, mb, rng)
                grads = tree_map(lambda a, g: a + g.float(), grads, g_i)
                loss_sum = loss_sum + loss_i
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss_sum / accum_steps
            metrics = {"loss": loss}

        with obs.span("train.clip"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        metrics = dict(metrics)
        metrics.setdefault("loss", loss)
        with obs.span("train.optimizer"):
            if guard_nonfinite:
                ok = torch.isfinite(gnorm)
                grads = tree_map(
                    lambda g: torch.where(ok, g, torch.zeros_like(g)), grads)
                metrics["nonfinite_skips"] = (~ok).float()
            else:
                # Guard off: the key is still reported, a 0 on the gradient
                # norm's device like every other metric.
                metrics["nonfinite_skips"] = torch.zeros(
                    (), dtype=torch.float32, device=gnorm.device)
            lr = cosine_schedule(state.step, base_lr, warmup_steps,
                                 total_steps)
            new_params, new_opt = opt_update(state.params, grads,
                                             state.opt_state, lr,
                                             weight_decay=weight_decay)
            if guard_nonfinite:
                keep_new = lambda n, o: torch.where(ok, n, o)
                new_params = tree_map(keep_new, new_params, state.params)
                with obs.span("train.wait"):
                    ok_host = ok.cpu()
                new_opt = type(new_opt)(
                    torch.where(ok_host, new_opt.step, state.opt_state.step),
                    tree_map(keep_new, new_opt.m, state.opt_state.m),
                    tree_map(keep_new, new_opt.v, state.opt_state.v))
        metrics.update({"grad_norm": gnorm, "lr": lr})
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return init_state, train_step


def instrument_train_step(step_fn, *, tokens_per_step: float | None = None,
                          metric_keys=("loss", "grad_norm",
                                       "nonfinite_skips")):
    """Wrap a ``train_step`` so each call emits one obs ``train_step`` event
    when a tracer is scoped — and is the identity call (same objects
    returned, no added work beyond one contextvar read) when none is.

    The wrapper adds no device synchronise: it measures the host time of
    the call (a step of the port already waits once, for the gradient norm,
    in ``train.wait``, so this is close to the step's time) and records the
    selected metrics
    as the step's 0-d tensors, resolved to floats when the tracer
    serializes, off the hot path. ``tokens_per_step`` (e.g. batch * n_res)
    rides along for throughput aggregation."""
    from repro_torch.obs.trace import current_tracer, monotonic_ns

    step_counter = [0]

    def instrumented(state, batch, rng=None):
        tr = current_tracer()
        if tr is None:
            return step_fn(state, batch, rng)
        t0 = monotonic_ns()
        state, metrics = step_fn(state, batch, rng)
        dur = monotonic_ns() - t0
        step_counter[0] += 1
        tr.emit("train_step", "train_step", step=step_counter[0],
                dur_ns=dur, tokens=tokens_per_step,
                metrics={k: metrics[k] for k in metric_keys
                         if k in metrics})
        return state, metrics

    return instrumented
