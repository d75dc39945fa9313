"""Train the PyTorch port's AlphaFold on synthetic protein batches, with
crash-safe checkpoints that a rerun resumes from, and optional step
telemetry. The port's counterpart of ``examples/train_alphafold_mini.py``.

  PYTHONPATH=src python scripts/torch_train_alphafold.py --steps 300
  PYTHONPATH=src python scripts/torch_train_alphafold.py --config full \\
      --batch 1 --n-res 256 --n-seq 128 --steps 10 --ckpt-every 5 \\
      --trace build/train_events.jsonl
  python -m repro_torch.obs report build/train_events.jsonl --strict
  PYTHONPATH=src python scripts/torch_train_alphafold.py --device cpu \\
      --steps 20                                  # the plain versions

It runs on the card unless given ``--device cpu``. On start it resumes from
the newest intact checkpoint in ``--ckpt-dir``. Step ``k``'s batch is the
k-th of a seeded stream and its dropout masks come from a generator seeded
by ``k``, so a run that crashed and resumed takes the same batches and masks
as one that never stopped. Rerun with the same flags to resume.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import FULL, MINI, SMOKE  # noqa: E402
from repro_torch.core.evoformer import REMAT_CONTEXTS  # noqa: E402
from repro_torch.data import protein_batches  # noqa: E402
from repro_torch.exec import FastFold  # noqa: E402
from repro_torch.exec.plan import PRESETS, preset  # noqa: E402
from repro_torch.layers.params import tree_leaves  # noqa: E402
from repro_torch.obs import use_tracer  # noqa: E402
from repro_torch.train import (instrument_train_step,  # noqa: E402
                               make_train_step)
from repro_torch.train.checkpoint import (latest_checkpoint,  # noqa: E402
                                          restore_checkpoint,
                                          save_checkpoint)

CONFIGS = {"smoke": SMOKE, "mini": MINI, "full": FULL}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="smoke", choices=sorted(CONFIGS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n-res", type=int, default=16)
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--plan", default="default", choices=sorted(PRESETS),
                    help="ExecutionPlan preset the session binds")
    ap.add_argument("--trace", default=None, metavar="EVENTS.jsonl",
                    help="record obs train_step telemetry to this JSONL "
                         "file (inspect with `python -m repro_torch.obs "
                         "report`)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=sorted(REMAT_CONTEXTS),
                    help="what each checkpointed Evoformer block keeps")
    return ap.parse_args(argv)


def main(argv=None):
    """Train to ``--steps``, resuming where the checkpoints say; returns the
    final train state."""
    args = parse_args(argv)
    if args.trace:
        with use_tracer() as tr:
            state = _run(args)
        n = tr.dump_jsonl(args.trace)
        print(f"wrote {args.trace} ({n} events)")
        return state
    return _run(args)


def _run(args):
    cfg = CONFIGS[args.config]
    cfg = dataclasses.replace(cfg, evoformer=dataclasses.replace(
        cfg.evoformer, remat_policy=args.remat_policy))
    ff = FastFold(cfg, device=args.device, plan=preset(args.plan))
    params = ff.init(seed=0)
    print(f"config={args.config} plan={args.plan} device={ff.device} "
          f"remat_policy={args.remat_policy} "
          f"params={sum(p.numel() for p in tree_leaves(params)):,}")

    init_state, train_step = make_train_step(
        ff.loss_fn, base_lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = instrument_train_step(
        train_step, tokens_per_step=args.batch * args.n_res)
    state = init_state(params)

    ckpt = latest_checkpoint(args.ckpt_dir)
    if ckpt:
        state = restore_checkpoint(ckpt, state)
        print(f"resumed from {ckpt} at step {int(state.step)}")

    gen = protein_batches(batch=args.batch, n_seq=args.n_seq,
                          n_res=args.n_res, seed=0)
    for _ in range(int(state.step)):        # the batches taken before
        next(gen)
    start, t0 = int(state.step), time.perf_counter()
    while int(state.step) < args.steps:
        batch = next(gen).as_dict()
        masks = torch.Generator(ff.device).manual_seed(int(state.step))
        state, metrics = step_fn(state, batch, masks)
        s = int(state.step)
        if s % 20 == 0 or s == start + 1:
            loss = float(metrics["loss"])           # waits for the step
            dt = (time.perf_counter() - t0) / (s - start)
            print(f"step {s:4d}  loss {loss:7.4f}  "
                  f"msa {float(metrics['masked_msa']):6.4f}  "
                  f"dist {float(metrics['distogram']):6.4f}  "
                  f"fape {float(metrics['fape']):6.4f}  "
                  f"({dt * 1e3:.0f} ms/step)")
        if s % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, s, state)
            print("checkpointed:", path)
    print("done in", round(time.perf_counter() - t0, 1), "s")
    return state


if __name__ == "__main__":
    main()
