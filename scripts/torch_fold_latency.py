#!/usr/bin/env python3
"""Fold latency of the PyTorch port, repeated, for A/B runs in one call.

    PYTHONPATH=src python scripts/torch_fold_latency.py [--n-res 256 384] \
        [--repeats 5] [--plan default|attention-oracle]

Serves ``--repeats`` requests at each residue count through
``FastFold(FULL)`` (48 blocks, n_recycle = 3, batch 1, s = 128, bf16,
every weight randomised from a seed) after one uncounted request per
shape, each timed on the host clock around the call and a synchronise.
Prints one JSON line per shape: every latency, their median and least,
and the card's name and power limit. To compare two checkouts on one card,
run it once per checkout with ``PYTHONPATH`` pointing at that checkout's
``src``, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-res", type=int, nargs="+", default=[256, 384])
    ap.add_argument("--n-seq", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--plan", default="default",
                    choices=("default", "attention-oracle"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_fold_latency: no CUDA device", file=sys.stderr)
        return 3
    import repro_torch
    from repro_torch.configs import FULL
    from repro_torch.data import protein_batches
    from repro_torch.exec import ExecutionPlan, FastFold, KernelPolicy
    from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                     randomize_tree)

    kern = (KernelPolicy(attention="oracle") if args.plan == "attention-oracle"
            else KernelPolicy())
    ff = FastFold(FULL, plan=ExecutionPlan(kernels=kern))
    params = params_from_numpy(randomize_tree(params_to_numpy(
        ff.init(seed=0)), 1), device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for r in args.n_res:
        batch = next(protein_batches(batch=1, n_seq=args.n_seq, n_res=r,
                                     seed=2)).as_dict()
        ff.forward(params, batch)                # uncounted
        torch.cuda.synchronize()
        secs = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            ff.forward(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print(json.dumps({"package": repro_torch.__file__, "plan": args.plan,
                          "n_res": r, "n_seq": args.n_seq, "latency_s": secs,
                          "median_s": statistics.median(secs),
                          "min_s": min(secs), "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
