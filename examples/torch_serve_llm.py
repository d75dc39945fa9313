"""Serve a reduced assigned-architecture LM with batched requests, on the
PyTorch port.

  PYTHONPATH=src python examples/torch_serve_llm.py --arch qwen2-1.5b --requests 8
  PYTHONPATH=src python examples/torch_serve_llm.py --chaos --fault-seed 7
  PYTHONPATH=src python examples/torch_serve_llm.py --device cpu

Demonstrates continuous batching (more requests than slots), per-request
sampling temperature, and EOS handling, on any of the 10 assigned archs.
It runs on the card unless given ``--device cpu``.

Failure handling (see repro_torch/resilience/__init__.py for the full
matrix): the engine serves every request to a *typed* terminal state — no
failure mode hangs the batch or silently drops tokens.

  * Admission control: ``submit`` raises ``AdmissionError`` (typed
    backpressure) for over-length prompts, a full pending queue
    (``max_pending``), or a (plan, length) that exceeds the decoder
    admission model under the request plan's budget.
  * Deadlines: ``submit(..., deadline=N)`` fails the request with
    ``DeadlineExceeded`` after N engine steps, queued or active.
  * Retry: ``submit(..., retry=RetryPolicy(...))`` requeues transient
    failures with capped exponential backoff (in engine steps); the retry
    re-prefills from scratch, so tokens are never lost or duplicated.
  * Non-finite quarantine: a per-slot guard fails only the slot whose
    logits went non-finite — the rest of the batch is untouched.
  * Graceful degradation: on OOM the request walks ``plan.degrade()``
    (tighter MemoryPolicy chunks -> oracle kernel leg), recording each
    rung on ``Request.fallback_chain``.

``--chaos`` drives all of this live: it wraps the run in a seeded
``inject_faults`` scope with a mixed fault schedule and prints each
request's terminal status, attempts, and fallback chain.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.layers.params import tree_map
from repro_torch.models.decoder import init_model
from repro_torch.resilience import FaultSpec, RetryPolicy, inject_faults
from repro_torch.serving.engine import ServingEngine


def chaos_specs():
    """A mixed schedule: one transient decode blip (retried), one OOM
    (degraded down the plan ladder), one NaN poisoning (quarantined +
    retried)."""
    return [
        FaultSpec("transient", "decode", uid=1, times=1),
        FaultSpec("oom", "decode", uid=2, times=1),
        FaultSpec("nonfinite", "decode", uid=3, times=1),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--chaos", action="store_true",
                    help="inject a deterministic fault schedule and show "
                         "retry / quarantine / degradation handling")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, or 'cpu')")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced_variant=True)
    params = tree_map(lambda t: t.to(device),
                      init_model(torch.Generator().manual_seed(0), cfg))
    engine = ServingEngine(params, cfg, n_slots=args.slots, max_seq=128,
                           device=device)

    retry = RetryPolicy(
        max_attempts=3, backoff=1.0,
        retryable=lambda e: not isinstance(e, (ValueError, TypeError)),
    ) if args.chaos else None

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=(4 + rng.integers(0, 12),))
        engine.submit(prompt, max_new_tokens=args.max_new,
                      temperature=args.temperature, retry=retry)
    if args.chaos:
        with inject_faults(*chaos_specs(), seed=args.fault_seed) as inj:
            finished = engine.run()
        print(f"chaos: injected {inj.total_fired} faults: {inj.counts}")
    else:
        finished = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.generated) for r in finished)
    print(f"arch={args.arch} served {len(finished)} requests, "
          f"{total_toks} tokens in {dt:.2f}s "
          f"({total_toks / dt:.1f} tok/s on {args.slots} slots)")
    for r in finished[: 8 if args.chaos else 4]:
        line = (f"  req {r.uid}: prompt[{len(r.prompt)}] "
                f"status={r.status} -> {r.generated}")
        if r.attempts > 1:
            line += f" (attempts={r.attempts})"
        if r.fallback_chain:
            line += f" (degraded {len(r.fallback_chain)}x)"
        if r.error is not None:
            line += f" [{type(r.error).__name__}]"
        print(line)


if __name__ == "__main__":
    main()
