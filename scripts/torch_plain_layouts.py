#!/usr/bin/env python3
"""Which plain versions' outputs the fused ops copy to lay them out as the
kernels lay out theirs (``kernels/ops.py``: ``_laid_out`` and the
``.contiguous()`` on each plain result), and how many bytes that copies.

    PYTHONPATH=src python scripts/torch_plain_layouts.py [--device cuda|cpu] \
        [--smoke] [--n-res 384] [--train-n-res 256] [--blocks 2]

Wraps each plain version that ``ops`` calls (``ref.*_ref``) so that every
call notes whether each of its tensor outputs is contiguous, then, under
each plan (default, attention-oracle, oracle), serves one request (batch
1, s = 128, n_recycle = 0, ``--n-res`` residues) and takes one training
step (``--train-n-res`` residues) through ``FastFold`` at FULL widths cut
to ``--blocks`` Evoformer blocks (``--smoke``: SMOKE widths, for the CPU),
every weight randomised from a seed. Each block runs the same ops at the
same shapes, so a cut's layouts are every block's. Prints one JSON line
per plan and path: each plain version's calls, the outputs that were not
contiguous, and their bytes (what the copy moves, read once and written
once), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-res", type=int, default=384)
    ap.add_argument("--train-n-res", type=int, default=256)
    ap.add_argument("--n-seq", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=2)
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_plain_layouts: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import FULL, SMOKE
    from repro_torch.data import protein_batches
    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import ExecutionPlan, KernelPolicy, preset
    from repro_torch.kernels import ops
    from repro_torch.train import make_train_step
    from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                     randomize_tree)

    seen: dict = {}

    def noting(name, fn):
        def plain(*a, **kw):
            out = fn(*a, **kw)
            row = seen.setdefault(name, {"calls": 0, "outputs": 0,
                                         "not_contiguous": 0, "bytes": 0,
                                         "shapes": []})
            row["calls"] += 1
            for t in (out if isinstance(out, tuple) else (out,)):
                if not isinstance(t, torch.Tensor):
                    continue
                row["outputs"] += 1
                if not t.is_contiguous():
                    row["not_contiguous"] += 1
                    row["bytes"] += t.numel() * t.element_size()
                    shape = [list(t.shape), str(t.dtype)]
                    if shape not in row["shapes"]:
                        row["shapes"].append(shape)
            return out
        return plain

    for name in dir(ops.ref):
        if name.endswith("_ref") and callable(getattr(ops.ref, name)):
            setattr(ops.ref, name, noting(name, getattr(ops.ref, name)))

    base = SMOKE if args.smoke else FULL
    cfg = dataclasses.replace(base, evoformer=dataclasses.replace(
        base.evoformer, n_blocks=args.blocks))
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if args.device == "cuda" else "cpu")
    tree = None
    for plan in ("default", "attention-oracle", "oracle"):
        ff = FastFold(cfg, device=args.device, plan=ExecutionPlan(
            kernels=KernelPolicy(attention="oracle"))
            if plan == "attention-oracle" else preset(plan))
        if tree is None:
            tree = randomize_tree(params_to_numpy(ff.init(seed=0)), 1)
        params = params_from_numpy(tree, device=args.device)
        for path, n_res in (("serve", args.n_res),
                            ("train", args.train_n_res)):
            batch = next(protein_batches(batch=1, n_seq=args.n_seq,
                                         n_res=n_res, seed=2)).as_dict()
            seen.clear()
            if path == "serve":
                ff.forward(params, batch, n_recycle=0)
            else:
                init, step = make_train_step(ff.loss_fn)
                step(init(params), batch, None)
            if args.device == "cuda":
                torch.cuda.synchronize()
            print(json.dumps({"plan": plan, "path": path, "n_res": n_res,
                              "n_seq": args.n_seq, "blocks": args.blocks,
                              "widths": "SMOKE" if args.smoke else "FULL",
                              "device": smi, "plain": seen}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
