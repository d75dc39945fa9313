"""Serving launcher: a decoder LM behind the serving engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --device cpu --requests 6 --max-new 12

The reference's flags (``src/repro/launch/serve.py``), plus ``--device``:
the card by default, ``cpu`` to run the plain PyTorch versions there (meant
for ``--reduced``). Weights are the port's own init from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.exec.plan import PRESETS, preset
from repro_torch.models.decoder import init_model
from repro_torch.layers.params import tree_map
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--plan", default="default", choices=sorted(PRESETS),
                    help="ExecutionPlan preset the engine binds")
    ap.add_argument("--device", default=None,
                    help="where to run: the card by default, or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced_variant=args.reduced)
    params = tree_map(lambda t: t.to(device),
                      init_model(torch.Generator().manual_seed(0), cfg))
    engine = ServingEngine(params, cfg, n_slots=args.slots,
                           max_seq=args.max_seq, plan=preset(args.plan),
                           device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab, size=(8,)),
                      max_new_tokens=args.max_new,
                      temperature=args.temperature)
    finished = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in finished)
    print(f"{args.arch}: {len(finished)} requests, {toks} tokens, "
          f"{toks/dt:.1f} tok/s")


if __name__ == "__main__":
    main()
