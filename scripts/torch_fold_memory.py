#!/usr/bin/env python3
"""Device memory of one fold of the PyTorch port, phase by phase.

    PYTHONPATH=src python scripts/torch_fold_memory.py --n-res 1024 2048 \
        [--plan default|attention-oracle] [--memory '{"hbm_budget": 7e9}']

Runs ``FastFold(FULL).forward`` at FULL widths cut to 2 Evoformer blocks,
no recycling, batch 1, s = 128, bf16, weights from a seed, on the card.
Every phase of the fold (the embedders, each Evoformer sub-module and
residual add, the structure module) is wrapped: the peak allocator counters
are reset where the phase starts and read where it ends, so each line says
what was live when the phase began and the most that was live during it,
both above what was allocated before the fold. The phase whose peak is the
fold's sets ``torch.cuda.max_memory_allocated``; the AutoChunk model's
terms (``memory/autochunk.py``) are printed beside it. One JSON line per
phase and one per fold.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (module, function) of each phase wrapped, as the fold looks them up.
PHASES = {
    "repro_torch.core.alphafold": ("embed_inputs", "embed_recycle",
                                   "structure_module"),
    "repro_torch.core.evoformer": ("msa_row_attention", "msa_col_attention",
                                   "msa_transition", "outer_product_mean",
                                   "triangle_mult_outgoing",
                                   "triangle_mult_incoming",
                                   "triangle_attention", "transition",
                                   "_residual_add"),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-res", type=int, nargs="+", default=[1024])
    ap.add_argument("--n-seq", type=int, default=128)
    ap.add_argument("--plan", default="default",
                    choices=("default", "attention-oracle"))
    ap.add_argument("--memory", default="{}",
                    help="MemoryPolicy fields as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("torch_fold_memory: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import FULL
    from repro_torch.core.alphafold import planned_evoformer
    from repro_torch.data import protein_batches
    from repro_torch.exec import ExecutionPlan, FastFold, KernelPolicy
    from repro_torch.exec.plan import use_plan
    from repro_torch.memory.autochunk import (evoformer_peak_bytes,
                                              outside_block_bytes,
                                              site_branches)
    from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                     randomize_tree)

    cfg = dataclasses.replace(FULL, n_recycle=0, evoformer=dataclasses.replace(
        FULL.evoformer, n_blocks=2))
    kern = (KernelPolicy(attention="oracle") if args.plan == "attention-oracle"
            else KernelPolicy())
    plan = ExecutionPlan(kernels=kern).with_memory(**json.loads(args.memory))
    ff = FastFold(cfg, plan=plan)
    params = params_from_numpy(randomize_tree(params_to_numpy(
        ff.init(seed=0)), 1), device="cuda")

    stats: dict[str, list] = {}
    depth = [0]
    base = [0]

    def wrap(name, fn):
        def wrapped(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated() - base[0]
            torch.cuda.reset_peak_memory_stats()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base[0]
                depth[0] -= 1
                st = stats.setdefault(name, [0, 0, 0])
                st[0] += 1
                st[1] = max(st[1], live)
                st[2] = max(st[2], peak)
        return wrapped

    for mod_name, names in PHASES.items():
        mod = importlib.import_module(mod_name)
        for n in names:
            setattr(mod, n, wrap(n, getattr(mod, n)))

    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for r in args.n_res:
        batch = ff.batch_to_device(next(protein_batches(
            batch=1, n_seq=args.n_seq, n_res=r, seed=9)).as_dict())
        stats.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with use_plan(plan):
            evo, chunks, _ = planned_evoformer(cfg, (1, args.n_seq, r),
                                               device="cuda")
            branches = site_branches(evo, batch=1, n_seq=args.n_seq, n_res=r,
                                     device="cuda", dtype=cfg.compute_dtype)
        base[0] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ff.forward(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for name, (calls, live, peak) in stats.items():
            print(json.dumps({"phase": name, "n_res": r, "calls": calls,
                              "live_at_entry_bytes": live,
                              "peak_bytes": peak}), flush=True)
        terms = evoformer_peak_bytes(
            evo, batch=1, n_seq=args.n_seq, n_res=r,
            inference_chunk=evo.inference_chunk, opm_chunk=evo.opm_chunk,
            attn_kv_tile=evo.attn_kv_tile, tri_k_tile=evo.tri_k_tile,
            opm_s_tile=evo.opm_s_tile, dtype=cfg.compute_dtype, **branches)
        terms.update(outside_block_bytes(evo, batch=1, n_seq=args.n_seq,
                                         n_res=r, dtype=cfg.compute_dtype))
        top = max(stats, key=lambda k: stats[k][2])
        print(json.dumps({
            "fold": args.plan, "memory_policy": json.loads(args.memory),
            "n_res": r, "n_seq": args.n_seq, "n_blocks": 2,
            "chunk_plan": chunks.describe() if chunks else None,
            "peak_bytes": max(s[2] for s in stats.values()),
            "peak_phase": top, "model_terms": terms,
            "model_bytes": sum(terms.values()), "seconds": secs,
            "device": smi.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
