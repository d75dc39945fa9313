"""Training launcher: a decoder LM trained on synthetic Zipf tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --device cpu --steps 50 --batch 4 --seq 64

The reference's flags (``src/repro/launch/train.py``), plus ``--device``:
the card by default, ``cpu`` to run the plain PyTorch versions there (meant
for ``--reduced``). Weights are the port's own init from seed 0. Each step
is ``make_train_step`` over ``lm_loss`` (bf16 compute, fp32 master weights
and optimizer state, a checkpoint per layer), wrapped by
``instrument_train_step`` with ``tokens_per_step = batch · seq``, on
``lm_batches(seed=0)``; a modality configuration gets zero bf16
``prefix_embeds``, as in the reference. ``--trace`` writes the steps'
``train_step`` events (``python -m repro_torch.obs report`` reads them),
``--ckpt-dir`` saves the final state with ``train/checkpoint.py`` (in the
reference's format), ``--plan`` runs under one of the port's presets.

``train`` is the loop itself, for a caller that brings its own weights
(full-width random weights drawn on the card, say) and watches each step
through ``on_step``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.exec.plan import PRESETS, preset, use_plan
from repro_torch.layers.params import count_params, tree_map
from repro_torch.models.decoder import init_model, lm_loss
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.loop import instrument_train_step, make_train_step


def lm_batch(lb, cfg: ModelConfig, device) -> dict:
    """An ``LMBatch`` (numpy) as the loss's batch on ``device``: int64
    tokens and targets, the fp32 mask, and zero bf16 ``prefix_embeds``
    (B, P, d) for a modality configuration with prefix tokens."""
    batch = {"tokens": torch.as_tensor(lb.tokens, dtype=torch.long),
             "targets": torch.as_tensor(lb.targets, dtype=torch.long),
             "mask": torch.as_tensor(lb.mask)}
    batch = {k: v.to(device) for k, v in batch.items()}
    if cfg.modality and cfg.modality.n_prefix_tokens:
        batch["prefix_embeds"] = torch.zeros(
            (lb.tokens.shape[0], cfg.modality.n_prefix_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return batch


def make_lm_step(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                 lr: float = 3e-4, optimizer: str = "adamw", accum: int = 1):
    """(init_state, step): the reference's schedule (warm-up
    ``max(5, steps // 20)``, cosine to ``steps``), the step instrumented
    with ``batch · seq`` tokens."""
    init_state, train_step = make_train_step(
        lambda p, b, r: lm_loss(p, b, cfg), optimizer=optimizer, base_lr=lr,
        warmup_steps=max(5, steps // 20), total_steps=steps,
        accum_steps=accum)
    return init_state, instrument_train_step(train_step,
                                             tokens_per_step=batch * seq)


def train(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int,
          device, lr: float = 3e-4, optimizer: str = "adamw", accum: int = 1,
          on_step=None):
    """``steps`` optimizer steps from ``params`` (on ``device``; the state
    takes them over, so pass no reference you keep). ``on_step(i, state,
    metrics)`` is called after step i. Returns the final ``TrainState``."""
    init_state, step_fn = make_lm_step(cfg, steps=steps, batch=batch,
                                       seq=seq, lr=lr, optimizer=optimizer,
                                       accum=accum)
    state = init_state(params)
    del params
    print(f"{cfg.name}: {count_params(state.params):,} params on {device}")
    gen = lm_batches(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)
    for i in range(steps):
        state, metrics = step_fn(state, lm_batch(next(gen), cfg, device))
        if on_step is not None:
            on_step(i, state, metrics)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:4d} loss {float(metrics['loss']):.4f} "
                  f"ppl {float(metrics['ppl']):.1f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "lamb"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--plan", default="default", choices=sorted(PRESETS),
                    help="ExecutionPlan preset the run executes under")
    ap.add_argument("--trace", default=None, metavar="EVENTS.jsonl",
                    help="record obs train_step telemetry to this JSONL file "
                         "(inspect with `python -m repro_torch.obs report`)")
    ap.add_argument("--device", default=None,
                    help="where to run: the card by default, or 'cpu'")
    args = ap.parse_args(argv)

    with use_plan(preset(args.plan)):
        if args.trace:
            from repro_torch.obs import use_tracer

            with use_tracer() as tr:
                _run(args)
            n = tr.dump_jsonl(args.trace)
            print(f"wrote {args.trace} ({n} events)")
        else:
            _run(args)


def _run(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced_variant=args.reduced)
    t0 = time.time()
    state = train(cfg, tree_map(lambda t: t.to(device), init_model(
                      torch.Generator().manual_seed(0), cfg)),
                  steps=args.steps, batch=args.batch, seq=args.seq,
                  device=device, lr=args.lr, optimizer=args.optimizer,
                  accum=args.accum)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")
    if args.ckpt_dir:
        print("saved:", save_checkpoint(args.ckpt_dir, args.steps, state))


if __name__ == "__main__":
    main()
