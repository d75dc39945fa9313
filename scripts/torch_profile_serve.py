#!/usr/bin/env python3
"""Where a FULL-width fold spends its time on the GPU (PyTorch port).

    PYTHONPATH=src python scripts/torch_profile_serve.py [--n-res 256 384] [--n-seq 128]

For each residue count, serves one request through ``FastFold(FULL)`` (48
blocks, n_recycle = 3, every weight randomised from a seed): once after a
warm-up pass, unprofiled, for its latency, then once under
``torch.profiler``. Prints, as JSON lines: the latency, the summed device
time of all kernels and its share of the profiled wall time (the device's
busy share), the device time by group, and the PyTorch operators and the
kernels that take the most device time.

A kernel is grouped by the operator that launched it, not by its name: the
profiler's raw events give each kernel the correlation id of a CPU event (the
``aten::`` op around its launch, or a runtime event such as ``Command
Buffer Full`` inside it), and the script walks up from that event to the
innermost ``aten::`` op. Each kernel is counted once, from the kernel's
side: the CPU events' own kernel lists can name one kernel twice when ids
collide. Matrix products are the kernels of ``aten::mm``/``bmm``/
``addmm``/..., copies and casts those of ``aten::copy_``/``_to_copy``/
``clone``. The port's own kernels are launched through ctypes, outside any
operator, and are grouped by their names.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import FULL
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.kernels import _build
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 randomize_tree)

PORT_KERNELS = ("layer_norm_kernel", "bias_sigmoid_mul_kernel",
                "flash_fwd_kernel")
GEMM_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
            "aten::addbmm", "aten::_addmm_activation"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::clone"}


def group_of_op(op: str) -> str:
    if op == "(no aten op)":
        return "launched outside any aten op"
    if op in GEMM_OPS:
        return "matrix products (aten mm ops)"
    if op in COPY_OPS:
        return "copies and casts (aten copy ops)"
    return "other aten ops"


def _aten_op(evt):
    """The innermost ``aten::`` op at or above a CPU event, or None."""
    while evt is not None and not evt.name.startswith("aten::"):
        evt = evt.cpu_parent
    return evt.name if evt is not None else None


def _port_kernel(name: str):
    return next((k for k in PORT_KERNELS if k in name), None)


def device_time(prof):
    """(total ms, {group: [ms, launches]}, {op: [ms, launches, calls]},
    {kernel name: [ms, launches]}) of one profiled run."""
    cpu_by_id = defaultdict(list)
    by_op = defaultdict(lambda: [0.0, 0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU:
            cpu_by_id[evt.id].append(evt)
            if evt.name in GEMM_OPS:
                by_op[evt.name][2] += 1
    by_kernel = defaultdict(lambda: [0.0, 0])
    groups = defaultdict(lambda: [0.0, 0])
    # The raw events carry each kernel's link to its CPU event.
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        name = evt.name()
        ms = (evt.end_ns() - evt.start_ns()) / 1e6
        k = by_kernel[name]
        k[0] += ms
        k[1] += 1
        port = _port_kernel(name)
        if port:
            group = f"{port} (port)"
        else:
            # An aten op holding the id itself comes first; any other
            # event with that id is walked up to its op.
            cands = sorted(cpu_by_id.get(evt.linked_correlation_id(), ()),
                           key=lambda c: not c.name.startswith("aten::"))
            op = next((o for o in map(_aten_op, cands) if o), "(no aten op)")
            o = by_op[op]
            o[0] += ms
            o[1] += 1
            group = group_of_op(op)
        groups[group][0] += ms
        groups[group][1] += 1
    return sum(v[0] for v in by_kernel.values()), groups, by_op, by_kernel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-res", type=int, nargs="+", default=[256])
    ap.add_argument("--n-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_serve: needs a CUDA device")
    _build.build_all()
    ff = FastFold(FULL)
    tree = randomize_tree(params_to_numpy(ff.init(seed=args.seed)),
                          args.seed + 1)
    params = params_from_numpy(tree, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for n_res in args.n_res:
        batch = next(protein_batches(batch=1, n_seq=args.n_seq, n_res=n_res,
                                     seed=args.seed + 2)).as_dict()
        ff.forward(params, batch, n_recycle=0)      # warm-up: cuBLAS, pools
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ff.serve(params, [batch])
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ff.serve(params, [batch])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        total_ms, groups, by_op, by_kernel = device_time(prof)
        if total_ms == 0:
            raise SystemExit("torch_profile_serve: the profiler recorded no "
                             "device time")
        head = {"n_res": n_res, "n_seq": args.n_seq}
        print(json.dumps({
            "device": smi, **head, "n_blocks": FULL.evoformer.n_blocks,
            "n_recycle": FULL.n_recycle, "latency_s": latency,
            "profiled_wall_s": wall, "device_kernel_ms": total_ms,
            "device_busy_share": total_ms / (wall * 1e3)}), flush=True)
        for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(json.dumps({**head, "group": name, "ms": ms, "launches": n,
                              "share": ms / total_ms}))
        for op in sorted(GEMM_OPS & by_op.keys()):
            ms, n, calls = by_op[op]
            print(json.dumps({**head, "gemm_op": op, "calls": calls,
                              "kernel_launches": n, "ms": ms}))
        top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:args.top]
        for op, (ms, n, _) in top:
            print(json.dumps({**head, "op": op, "ms": ms, "launches": n,
                              "share": ms / total_ms}))
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:args.top]
        for name, (ms, n) in top:
            print(json.dumps({**head, "kernel": name[:120], "ms": ms,
                              "launches": n, "share": ms / total_ms}),
                  flush=True)


if __name__ == "__main__":
    main()
