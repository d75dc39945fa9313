#!/usr/bin/env python3
"""Where a FULL-width fold, or a FULL-width training step, spends its time
on the GPU (PyTorch port).

    PYTHONPATH=src python scripts/torch_profile_serve.py [--n-res 256 384] [--n-seq 128]
    PYTHONPATH=src python scripts/torch_profile_serve.py --train [--n-res 256] [--remat-policy dots]
    PYTHONPATH=src python scripts/torch_profile_serve.py --plan attention-oracle
    PYTHONPATH=src python scripts/torch_profile_serve.py --attention --n-res 256 384
    PYTHONPATH=src python scripts/torch_profile_serve.py --triangle-dropout --n-res 256 384
    PYTHONPATH=src python scripts/torch_profile_serve.py --opm-layernorm --n-res 256 384
    PYTHONPATH=src python scripts/torch_profile_serve.py --gate-softmax --n-res 256 384 [--parent DIR]
    PYTHONPATH=src python scripts/torch_profile_serve.py --lm musicgen-medium [--plan oracle]

``--plan`` names the ExecutionPlan the model runs under: a preset
(default, oracle, interpret, triangle-oracle) or ``attention-oracle``,
``KernelPolicy(attention="oracle")``, whose four attention sites
materialize their scores and run the fused softmax kernel.

For each residue count, serves one request through ``FastFold(FULL)`` (48
blocks, n_recycle = 3, every weight randomised from a seed): once after a
warm-up pass, unprofiled, for its latency, then once under
``torch.profiler``. Prints, as JSON lines: the latency, the summed device
time of all kernels and its share of the profiled wall time (the device's
busy share), the device time by group, and the PyTorch operators and the
kernels that take the most device time.

With ``--attention`` it profiles the flash-attention kernels alone instead
(K5 ``flash_attention_cuda`` and K6 ``flash_attention_bwd_cuda``, bf16) at
the main path's attention calls for each residue count: MSA row (N = s,
S = r, the MSA heads, a pair bias shared by all s rows), MSA column (N = r,
S = s, no bias) and triangle (N = r, S = r, the pair heads, a bias shared by
all r rows), each with a key mask; q, k, v are column slices of one merged
projection, as the model lays them out. For each call it prints the device
time of every kernel the two wrappers launch, and that of
``F.scaled_dot_product_attention`` forward and backward on the same inputs
(bias and mask summed into one (N, H, S, S) mask), each over 20 launches
with the 50 MB L2 cache flushed before each (``repro_torch.timing``), the
least time for the work of K5 and K6, and the wrappers' host time per
call.

With ``--triangle-dropout`` it profiles K7 ``fused_triangle_cuda`` and
K3 ``bias_dropout_add_cuda`` alone, bf16. K7 at the main path's calls for
each residue count (outgoing and incoming: a_lin and ga column halves of
the merged (1, r, r, 2C) projection, the incoming mask a transposed view),
with the device time of each of its kernels (the pre-pass and the main
kernel), that of the main kernel at K = 0 (its k loop empty: the
epilogue, with the pre-pass's w_out conversion), the host time of a call,
and the cuBLAS composition the port ran before it. K3 at the training
step's dropout sites (r the first residue count, s the MSA depth, the
reduced fp32 keep mask of each distinct shape), beside ``torch.addcmul``.
Each is timed after the L2 flush and, without it, on cold inputs: the
calls cycle through copies of their inputs that together hold 200 MB or
more.

With ``--opm-layernorm`` it profiles K8 ``fused_opm_cuda`` and K1
``layer_norm_cuda`` alone, bf16, the same two ways. K8 at the main path's
call for each residue count (a and b (1, s, r, 32) masked by the MSA mask,
w (1024, 128)), with the same call at S = 0 (its s loop empty: the
projection and the store; the outer product is the difference) and the
cuBLAS composition the port ran before it. K1 at the MSA (1, s, r, 256),
pair (1, r, r, 128) and single (1, r, 384) rows, beside ``F.layer_norm``.
Each row carries the least time for the work (the bytes at 3.35 TB/s or
the operations at 989 TFLOP/s, the larger).

With ``--gate-softmax`` it profiles K2 ``bias_sigmoid_mul_cuda`` and K4
``fused_softmax_cuda`` alone, bf16, the same two ways, at the main path's
calls for each residue count: K2 at the MSA-row gate (1, s, r, 256) and
the pair gate (1, r, r, 128); K4 at the MSA row (s, 8, r, r; a pair bias
shared by the s rows), MSA column (r, 8, s, s; no bias) and triangle (r, 4,
r, r; a bias shared by the r rows) softmaxes, each with a key mask that
drops a tenth of the keys. Beside each: the library call (``sigmoid(g +
bg) * v``; ``torch.softmax`` on fp32 logits summed beforehand, which is
not the same function) and, with ``--parent DIR`` (the root of another
checkout of this repository, e.g. ``git archive`` of the parent commit
unpacked into an ignored directory), that checkout's own wrapper and
kernel, built from its sources into its own ``build/kernels/``, timed in
the order parent, this tree, this tree, parent.

With ``--lm ARCH`` it profiles the LM serving engine instead: ARCH (a
decoder config the port runs, e.g. musicgen-medium) at full width, fp32
weights drawn on the card from the seed, bf16 compute, behind
``ServingEngine`` with 4 slots of 512 rows, four prompts of 128 tokens
(``lm_batches``) admitted and decoding. It profiles one prefill of 128
tokens (``model_forward``, as the engine's prefill calls it) and one
engine decode step (``engine.step()``: one batched decode of the 4 slots
and the host's scheduling around it), each after warm-up calls, and
prints for each the same lines as a request's.

With ``--train`` it does the same for one step of
``make_train_step(FastFold(FULL).loss_fn)`` (the port's own init, bf16,
remat per block, dropout from a seeded generator) after a warm-up step, and
first times the step's parts apart, each ending in a synchronise: the
training loss's forward with all its passes, the same with no recycling
(the grad pass alone), its backward (the blocks' recompute included), and
the whole step; ``--remat-policy dots`` makes each checkpointed block keep
its matrix products for the backward.

A kernel is grouped by the operator that launched it, not by its name: the
profiler's raw events give each kernel the correlation id of a CPU event (the
``aten::`` op around its launch, or a runtime event such as ``Command
Buffer Full`` inside it), and the script walks up from that event to the
innermost ``aten::`` op. Each kernel is counted once, from the kernel's
side: the CPU events' own kernel lists can name one kernel twice when ids
collide. Matrix products are the kernels of ``aten::mm``/``bmm``/
``addmm``/..., copies and casts those of ``aten::copy_``/``_to_copy``/
``clone``. The port's own kernels are launched through ctypes, outside any
operator, and are grouped by the port kernel (K1..K8) their names belong
to (``PORT_KERNELS``).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import FULL
from repro_torch.core.evoformer import REMAT_CONTEXTS
from repro_torch.data import protein_batches
from repro_torch.exec import ExecutionPlan, FastFold, KernelPolicy, PRESETS
from repro_torch.kernels import _build
from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.timing import cold_device_ms, device_ms, host_us
from repro_torch.train import make_train_step
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 randomize_tree)

# The port's kernels, matched by name (first match wins), and the port
# kernel each belongs to: a device-time group per port kernel, whatever
# number of CUDA kernels its wrapper launches. The flash attention's bf16
# kernels run on tensor cores; its fp32 kernels (the *_fp32_kernel forward
# and the dq/dkv/dbias sweeps) serve fp32 runs only, as does K7's FMA
# kernel.
PORT_KERNELS = {
    "layer_norm_kernel": "K1 layer_norm",
    "layer_norm_vec_kernel": "K1 layer_norm",
    "bias_sigmoid_mul_kernel": "K2 bias_sigmoid_mul",
    "bias_dropout_add_kernel": "K3 bias_dropout_add",
    "softmax_rows_kernel": "K4 fused_softmax",
    "softmax_block_kernel": "K4 fused_softmax",
    "flash_fwd_mma_kernel": "K5 flash_attention_fwd",
    "flash_fwd_fp32_kernel": "K5 flash_attention_fwd",
    "delta_bf16_kernel": "K6 flash_attention_bwd",
    "delta_kernel": "K6 flash_attention_bwd",
    "flash_bwd_dq_mma_kernel": "K6 flash_attention_bwd",
    "flash_bwd_dkv_mma_kernel": "K6 flash_attention_bwd",
    "dbias_reduce_kernel": "K6 flash_attention_bwd",
    "dmask_reduce_kernel": "K6 flash_attention_bwd",
    "dq_kernel": "K6 flash_attention_bwd",
    "dkv_kernel": "K6 flash_attention_bwd",
    "dbias_kernel": "K6 flash_attention_bwd",
    "triangle_prepass_kernel": "K7 triangle_mult",
    "triangle_mult_mma_kernel": "K7 triangle_mult",
    "triangle_mult_fma_kernel": "K7 triangle_mult",
    "outer_product_mean_wgmma_kernel": "K8 outer_product_mean",
    "outer_product_mean_fma_kernel": "K8 outer_product_mean",
}
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
    """The port kernel (K1..K8) a CUDA kernel's name belongs to, or None."""
    return next((g for k, g in PORT_KERNELS.items() if k in name), None)


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


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serve_runner(ff, params, batch):
    """(the timed call, what the head line reports besides its time)."""
    ff.forward(params, batch, n_recycle=0)      # warm-up: cuBLAS, pools
    return (lambda: ff.serve(params, [batch])), {}


def train_runner(ff, params, batch, seed):
    """One training step after a warm-up step, and the parts of a step
    timed apart."""
    init, step = make_train_step(ff.loss_fn)
    state = [init(params)]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def run_step():
        state[0], metrics = step(state[0], batch, gen)
        float(metrics["loss"])

    run_step()                                  # warm-up
    grad_params = tree_map(lambda t: t.detach().requires_grad_(True),
                           state[0].params)
    parts = {}
    loss = [None]

    def fwd(n_recycle=None):
        loss[0], _ = ff.train_loss(grad_params, batch, gen,
                                   n_recycle=n_recycle)

    parts["loss_forward_s"] = _timed(fwd)
    parts["backward_s"] = _timed(lambda: torch.autograd.grad(
        loss[0], tree_leaves(grad_params)))
    parts["grad_pass_forward_s"] = _timed(lambda: fwd(0))
    loss[0] = None
    parts["no_grad_passes_s"] = (parts["loss_forward_s"]
                                 - parts["grad_pass_forward_s"])
    parts["step_s"] = _timed(run_step)
    parts["optimizer_and_rest_s"] = (parts["step_s"] - parts["loss_forward_s"]
                                     - parts["backward_s"])
    return run_step, {"train": True, "remat": True, "dtype": "bfloat16",
                      **parts}


PLANS = {**PRESETS, "attention-oracle": ExecutionPlan(
    kernels=KernelPolicy(attention="oracle"))}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def timed_call(name, fn, make_args, row, flush) -> None:
    """``fn(*make_args())`` timed two ways into ``row``: per kernel after
    the L2 flush, as everywhere in this script, and summed on cold inputs
    (``repro_torch.timing.cold_device_ms``); and its host time a call."""
    args = make_args()
    per_kernel = device_ms(lambda: fn(*args), flush)
    row[f"{name}_device_ms"] = sum(per_kernel.values())
    row[f"{name}_kernels_ms"] = per_kernel
    row[f"{name}_cold_device_ms"], row[f"{name}_cold_copies"] = cold_device_ms(
        fn, make_args)
    row[f"{name}_host_us"] = host_us(lambda: fn(*args))


def attention_profile(n_res_list, n_seq: int, seed: int, smi: str) -> None:
    """The device time of K5 and K6 and of SDPA at the main path's
    attention calls (see the module docstring)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    evo = FULL.evoformer
    d = evo.head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    for r in n_res_list:
        for site, n, s, h, shared in (("msa_row", n_seq, r, evo.msa_heads, True),
                                      ("msa_col", r, n_seq, evo.msa_heads, False),
                                      ("triangle", r, r, evo.pair_heads, True)):
            qkv = torch.randn((n, s, 3 * h * d), generator=gen,
                              device="cuda").to(bf16)
            q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
                       for i in range(3))
            bias = (torch.randn((1, h, s, s), generator=gen, device="cuda")
                    .to(bf16) if shared else None)
            keep = torch.rand((n, s), generator=gen, device="cuda") < 0.9
            mask = torch.where(keep, 0.0, -1e9).float()
            scale = d ** -0.5
            out, lse = flash_attention_cuda(q, k, v, bias, mask, scale)
            do = torch.randn(out.shape, generator=gen, device="cuda").to(bf16)
            qb, kb, vb = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            am = mask.to(bf16).view(n, 1, 1, s)
            if shared:
                am = (bias + am).reshape(n, h, s, s)
            am = am.detach().requires_grad_(shared)
            sdpa_out = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=am,
                                                      scale=scale)
            inputs = [qb, kb, vb] + ([am] if shared else [])
            gb = do.transpose(1, 2).contiguous()
            # The forward on inputs that need no gradient, as the model's
            # forward runs (PyTorch then picks another backend than with
            # a mask that needs one).
            fwd_in = [t.detach() for t in (qb, kb, vb, am)]
            calls = {
                "k5": lambda: flash_attention_cuda(q, k, v, bias, mask, scale),
                "k6": lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                       bias, mask, scale),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    *fwd_in[:3], attn_mask=fwd_in[3], scale=scale),
                "sdpa_backward": lambda: torch.autograd.grad(
                    sdpa_out, inputs, gb, retain_graph=True)}
            row = {"device": smi, "site": site, "n_res": r, "n_seq": n_seq,
                   "shape": [n, s, s, h, d], "dtype": "bfloat16"}
            # The least time for each kernel's work, as chip_smoke.py
            # counts it: each input read and each output written once
            # (the q/k/v views by their own size), and 4 (forward) or 10
            # (backward: five S x S x D products) N H S^2 D operations, at
            # 3.35 TB/s or 989 TFLOP/s, the larger.
            views = nbytes(q, k, v)
            extras = nbytes(bias, mask)
            fwd_bytes = views + extras + nbytes(out, lse)
            bwd_bytes = 2 * views + extras + nbytes(out, do, lse, bias)
            for name, nbytes_, ops in (("k5", fwd_bytes, 4), ("k6", bwd_bytes, 10)):
                row[f"{name}_bound_ms"] = max(
                    nbytes_ / 3.35e12, ops * n * h * s * s * d / 989e12) * 1e3
            for name, fn in calls.items():
                per_kernel = device_ms(fn, flush)
                row[f"{name}_device_ms"] = sum(per_kernel.values())
                row[f"{name}_kernels_ms"] = per_kernel
                row[f"{name}_host_us"] = host_us(fn)
            print(json.dumps(row), flush=True)


def triangle_dropout_profile(n_res_list, n_seq: int, seed: int,
                             smi: str) -> None:
    """K7 and K3 alone at the main path's calls (see the module docstring):
    per call the device time of every kernel the wrapper launches, K7's
    epilogue alone (the main kernel at K = 0: its k loop empty), the host
    time of a call, and the library yardstick's device and host time."""
    import torch.nn.functional as F
    from repro_torch.core.evoformer import DROPOUT_SITES
    from repro_torch.kernels.fused_elementwise import bias_dropout_add_cuda
    from repro_torch.kernels.triangle import fused_triangle_cuda

    evo = FULL.evoformer
    c, d = evo.tri_mult_dim, evo.d_pair
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16

    def randn(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    for r in n_res_list:
        for site in ("outgoing", "incoming"):
            def make_args():
                # a_lin and ga: column halves of the merged (1, r, r, 2C)
                # projections; the incoming update's mask is a transposed
                # view.
                ab, g = randn((1, r, r, 2 * c)), randn((1, r, r, 2 * c), 2.0)
                keep = (torch.rand((1, r, r), generator=gen, device="cuda")
                        < 0.9).float()
                mask = keep.transpose(1, 2) if site == "incoming" else keep
                return (ab[..., :c], g[..., :c], mask, randn((1, r, r, c)),
                        1 + randn((c,), 0.1, torch.float32),
                        randn((c,), 0.1, torch.float32),
                        randn((c, d), c ** -0.5, torch.float32),
                        randn((d,), 0.1, torch.float32),
                        randn((1, r, r, d), 2.0),
                        randn((d,), 1.0, torch.float32))

            def make_empty():
                # K = 0: the same call with its k loop empty (the epilogue).
                args = make_args()
                return (args[0][:, :, :0], args[1][:, :, :0],
                        args[2][:, :, :0],
                        torch.empty((1, r, 0, c), dtype=bf16, device="cuda"),
                        *args[4:])

            def make_composition_args():
                # The weights cast beforehand, outside the timed call.
                (a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
                 g_bias) = make_args()
                return (a_lin, ga, mask, b_full, gamma.to(bf16),
                        beta.to(bf16), w_out.t().contiguous().to(bf16),
                        b_out.to(bf16), g_lin, g_bias.to(bf16))

            def composition(a_lin, ga, mask, b_full, g_l, be_l, w_t, bo_l,
                            g_lin, gb_l):
                a = torch.sigmoid(ga) * a_lin * mask[..., None].to(bf16)
                o = torch.einsum("bikc,bjkc->bijc", a, b_full)
                y = F.layer_norm(o, (c,), g_l, be_l)
                return torch.sigmoid(g_lin + gb_l) * F.linear(y, w_t, bo_l)

            row = {"device": smi, "kernel": "triangle_mult", "site": site,
                   "n_res": r, "shape": [1, r, r, r, c, d], "dtype": "bfloat16"}
            timed_call("k7", fused_triangle_cuda, make_args, row, flush)
            timed_call("k7_k0_epilogue", fused_triangle_cuda, make_empty, row,
                       flush)
            timed_call("composition", composition, make_composition_args, row,
                       flush)
            print(json.dumps(row), flush=True)
    # K3 at the training crop's dropout sites (r = 256 or the first given),
    # each with its reduced fp32 mask as the main path draws it; the
    # library yardstick is torch.addcmul(residual, x, keep, value=1/(1-rate)).
    r = n_res_list[0]
    rates = {"msa": evo.dropout_msa, "pair": evo.dropout_pair}
    done = set()
    for site, axis in DROPOUT_SITES.items():
        shape = ((1, n_seq, r, evo.d_msa) if site == "msa_row"
                 else (1, r, r, evo.d_pair))
        kshape = tuple(1 if i == axis else n for i, n in enumerate(shape))
        if kshape in done:
            continue
        done.add(kshape)
        rate = rates["msa" if site == "msa_row" else "pair"]

        def make_args():
            keep = (torch.rand(kshape, generator=gen, device="cuda")
                    < 1 - rate).float()
            return randn(shape), randn(shape), keep, keep.to(bf16)

        row = {"device": smi, "kernel": "bias_dropout_add", "site": site,
               "shape": list(shape), "keep_shape": list(kshape),
               "rate": rate, "dtype": "bfloat16"}
        timed_call("k3", lambda x, res, keep, _: bias_dropout_add_cuda(
            x, None, res, keep, rate), make_args, row, flush)
        timed_call("addcmul", lambda x, res, _, keep_l: torch.addcmul(
            res, x, keep_l, value=1.0 / (1.0 - rate)), make_args, row, flush)
        print(json.dumps(row), flush=True)


def opm_layernorm_profile(n_res_list, n_seq: int, seed: int,
                          smi: str) -> None:
    """K8 and K1 alone at the main path's calls (see the module docstring):
    per call the device time after the flush and on cold inputs, the host
    time of a call, the least time for the work, and the library
    yardstick's times; for K8 also the call at S = 0 (its s loop empty:
    the projection and the store)."""
    import torch.nn.functional as F
    from repro_torch.kernels.layer_norm import layer_norm_cuda
    from repro_torch.kernels.triangle import fused_opm_cuda

    evo = FULL.evoformer
    c, d = evo.opm_dim, evo.d_pair
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16

    def randn(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def bound_ms(bytes_moved, ops):
        return max(bytes_moved / 3.35e12, ops / 989e12) * 1e3

    for r in n_res_list:
        def make_args(ns=n_seq):
            # The MSA mask masks one MSA row in ten and the last residue.
            mask = (torch.rand((1, ns, r), generator=gen, device="cuda")
                    < 0.9).float()
            mask[..., r - 1] = 0.0
            a = randn((1, ns, r, c)) * mask[..., None].to(bf16)
            b = randn((1, ns, r, c)) * mask[..., None].to(bf16)
            return (a, b, mask, mask.clone(), randn((c * c, d), 1.0 / c),
                    randn((d,), 1.0, torch.float32))

        def make_composition_args():
            a, b, ma, mb, w, bias = make_args()
            return a, b, ma, mb, w.t().contiguous(), bias.to(bf16)

        def composition(a, b, ma, mb, w_t, b_l):
            o = torch.einsum("bsic,bsjd->bijcd", a, b)
            norm = torch.einsum("bsi,bsj->bij", ma, mb)
            o = (o.float() / (norm[..., None, None] + 1e-3)).to(bf16)
            return F.linear(o.reshape(o.shape[:3] + (c * c,)), w_t, b_l)

        args = make_args()
        row = {"device": smi, "kernel": "outer_product_mean", "n_res": r,
               "shape": [1, n_seq, r, r, c, d], "dtype": "bfloat16",
               "bound_ms": bound_ms(nbytes(*args) + r * r * d * 2,
                                    2.0 * r * r * n_seq * (c * c + 1)
                                    + 2.0 * r * r * c * c * d)}
        timed_call("k8", fused_opm_cuda, make_args, row, flush)
        timed_call("k8_s0_projection", fused_opm_cuda, lambda: make_args(0),
                   row, flush)
        row["k8_outer_product_ms"] = (row["k8_device_ms"]
                                      - row["k8_s0_projection_device_ms"])
        timed_call("composition", composition, make_composition_args, row,
                   flush)
        print(json.dumps(row), flush=True)
        # K1 at the MSA, pair and single rows; F.layer_norm with the
        # weights cast beforehand.
        for site, shape in (("msa", (1, n_seq, r, evo.d_msa)),
                            ("pair", (1, r, r, evo.d_pair)),
                            ("single", (1, r, FULL.structure.c_s))):
            width = shape[-1]

            def make_ln_args():
                return (randn(shape, 2.0), 1 + randn((width,), 0.1, torch.float32),
                        randn((width,), 0.1, torch.float32))

            def make_library_args():
                x, g, b = make_ln_args()
                return x, g.to(bf16), b.to(bf16)

            x = make_ln_args()[0]
            row = {"device": smi, "kernel": "layer_norm", "site": site,
                   "n_res": r, "shape": list(shape), "dtype": "bfloat16",
                   "bound_ms": bound_ms(2 * nbytes(x) + 8 * width,
                                        8.0 * x.numel())}
            timed_call("k1", layer_norm_cuda, make_ln_args, row, flush)
            timed_call("layer_norm", lambda x, g, b: F.layer_norm(
                x, (width,), g, b), make_library_args, row, flush)
            print(json.dumps(row), flush=True)


def load_parent(root: str):
    """Another checkout's K2 and K4 wrappers, bound to its own ``_build``
    (its kernels' C interfaces, built from its sources into its own
    ``build/kernels/``): {"bias_sigmoid_mul": fn, "fused_softmax": fn}."""
    import importlib.util
    import sys

    kernels = Path(root).resolve() / "src" / "repro_torch" / "kernels"

    def load(stem):
        spec = importlib.util.spec_from_file_location(
            f"parent_{stem}", kernels / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load("_build")
    sys.modules["parent__build"] = build
    fe, fs = load("fused_elementwise"), load("fused_softmax")
    fe._build = fs._build = build
    for name in ("bias_sigmoid_mul", "fused_softmax"):
        build.entry(name)              # builds it, with nvcc's report
    return {"bias_sigmoid_mul": fe.bias_sigmoid_mul_cuda,
            "fused_softmax": fs.fused_softmax_cuda}


def gate_softmax_profile(n_res_list, n_seq: int, seed: int, smi: str,
                         parent: str | None) -> None:
    """K2 and K4 alone at the main path's calls (see the module
    docstring): per call, for this tree's wrapper, the parent's where
    given, and the library call, the device time after the flush and on
    cold inputs and the host time of a call; the least time for the work."""
    from repro_torch.kernels.fused_elementwise import bias_sigmoid_mul_cuda
    from repro_torch.kernels.fused_softmax import fused_softmax_cuda

    evo = FULL.evoformer
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    theirs = load_parent(parent) if parent else None

    def randn(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def bound_ms(bytes_moved):
        return bytes_moved / 3.35e12 * 1e3

    ours = {"bias_sigmoid_mul": bias_sigmoid_mul_cuda,
            "fused_softmax": fused_softmax_cuda}

    def timed(row, name, make_args, library, make_library_args):
        """Parent, this tree, this tree, parent; then the library call."""
        runs = [(name, ours[name])]
        if theirs is not None:
            runs = ([(f"parent_{name}", theirs[name])] + runs
                    + [(f"{name}_again", ours[name]),
                       (f"parent_{name}_again", theirs[name])])
        for label, fn in runs:
            timed_call(label, fn, make_args, row, flush)
        timed_call("library", library, make_library_args, row, flush)
        print(json.dumps(row), flush=True)

    for r in n_res_list:
        for site, shape in (("msa_row_gate", (1, n_seq, r, evo.d_msa)),
                            ("pair_gate", (1, r, r, evo.d_pair))):
            c = shape[-1]

            def make_gate_args():
                return (randn(shape, 2.0), randn((c,), 1.0, torch.float32),
                        randn(shape))

            g, bg, v = make_gate_args()
            row = {"device": smi, "kernel": "bias_sigmoid_mul", "site": site,
                   "n_res": r, "shape": list(shape), "dtype": "bfloat16",
                   "bound_ms": bound_ms(3 * nbytes(g) + nbytes(bg)),
                   "library_call": "torch.sigmoid(g + bg) * v"}
            del g, bg, v
            timed(row, "bias_sigmoid_mul", make_gate_args,
                  lambda g, bg, v: torch.sigmoid(g + bg) * v, make_gate_args)
        # (site, N, H, R = C, bias batches): the key mask drops a tenth of
        # the keys of every row n.
        for site, n, h, c, nb in (("msa_row", n_seq, evo.msa_heads, r, 1),
                                  ("msa_col", r, evo.msa_heads, n_seq, 0),
                                  ("triangle", r, evo.pair_heads, r, 1)):
            scale = evo.head_dim ** -0.5

            def make_softmax_args():
                mask = torch.where(torch.rand((n, c), generator=gen,
                                              device="cuda") < 0.9, 0.0, -1e9)
                return (randn((n, h, c, c), 4.0),
                        randn((nb, h, c, c)) if nb else None, mask.float(),
                        scale)

            def logits(x, bias, mask, scale):
                acc = x.float() * scale
                if bias is not None:
                    acc = acc + bias.float()
                return acc + mask.view(n, 1, 1, c)

            def make_library_args():
                return (logits(*make_softmax_args()),)

            x, bias, mask, _ = make_softmax_args()
            row = {"device": smi, "kernel": "fused_softmax", "site": site,
                   "n_res": r, "shape": [n, h, c, c], "bias": bool(nb),
                   "dtype": "bfloat16",
                   "bound_ms": bound_ms(2 * nbytes(x) + nbytes(bias, mask)),
                   "library_call": "torch.softmax(fp32 logits, -1), the "
                                   "logits summed beforehand"}
            del x, bias, mask
            timed(row, "fused_softmax", make_softmax_args,
                  lambda a: torch.softmax(a, -1), make_library_args)


def lm_runners(arch: str, plan, seed: int):
    """{phase: (the timed call, what the head line reports)} for the LM
    serving engine at full width (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.exec.plan import use_plan
    from repro_torch.models.decoder import init_model, model_forward
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.weights import random_params_like

    cfg = get_config(arch)
    with torch.device("meta"):
        skeleton = init_model(torch.Generator(), cfg)
    params = random_params_like(skeleton, seed, device="cuda")
    prompts = next(lm_batches(vocab=cfg.vocab, batch=4, seq=128,
                              seed=seed + 2)).tokens
    engine = ServingEngine(params, cfg, n_slots=4, max_seq=512, plan=plan)
    for p in prompts:
        engine.submit(p, max_new_tokens=400)
    engine.step()                   # admits the four, then one decode
    engine.step()                   # warm-up
    prompt = torch.as_tensor(prompts[:1], dtype=torch.long, device="cuda")

    def prefill():
        with use_plan(plan), torch.no_grad():
            model_forward(params, prompt, engine.cfg, mode="prefill",
                          max_cache_len=512)

    prefill()                       # warm-up
    head = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": "bfloat16", "weights": "fp32"}
    return {"prefill": (prefill, {**head, "tokens": 128}),
            "decode_step": (engine.step, {**head, "batch": 4})}


def report(prof, wall, head, latency, extra, top) -> None:
    total_ms, groups, by_op, by_kernel = device_time(prof)
    if total_ms == 0:
        raise SystemExit("torch_profile_serve: the profiler recorded no "
                         "device time")
    print(json.dumps({**head, "latency_s": latency, **extra,
                      "profiled_wall_s": wall, "device_kernel_ms": total_ms,
                      "device_busy_share": total_ms / (wall * 1e3)}),
          flush=True)
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({**head, "group": name, "ms": ms, "launches": n,
                          "share": ms / total_ms}))
    for op in sorted(GEMM_OPS & by_op.keys()):
        ms, n, calls = by_op[op]
        print(json.dumps({**head, "gemm_op": op, "calls": calls,
                          "kernel_launches": n, "ms": ms}))
    for op, (ms, n, _) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:top]:
        print(json.dumps({**head, "op": op, "ms": ms, "launches": n,
                          "share": ms / total_ms}))
    for name, (ms, n) in sorted(by_kernel.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(json.dumps({**head, "kernel": name[:120], "ms": ms,
                          "launches": n, "share": ms / total_ms}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-res", type=int, nargs="+", default=[256])
    ap.add_argument("--n-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead of a request")
    ap.add_argument("--attention", action="store_true",
                    help="profile the flash-attention kernels and SDPA alone")
    ap.add_argument("--triangle-dropout", action="store_true",
                    help="profile the triangle (K7) and bias-dropout-add "
                         "(K3) kernels alone")
    ap.add_argument("--opm-layernorm", action="store_true",
                    help="profile the outer-product-mean (K8) and LayerNorm "
                         "(K1) kernels alone")
    ap.add_argument("--gate-softmax", action="store_true",
                    help="profile the gating (K2) and fused softmax (K4) "
                         "kernels alone")
    ap.add_argument("--parent", default=None,
                    help="with --gate-softmax: the root of another checkout "
                         "whose K2 and K4 are timed beside this tree's")
    ap.add_argument("--lm", default=None, metavar="ARCH",
                    help="profile the LM serving engine on this decoder "
                         "config instead")
    ap.add_argument("--plan", choices=sorted(PLANS), default="default",
                    help="the ExecutionPlan the model runs under")
    ap.add_argument("--remat-policy", choices=sorted(REMAT_CONTEXTS),
                    default="nothing",
                    help="with --train: what each checkpointed Evoformer "
                         "block keeps for the backward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_serve: needs a CUDA device")
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.attention:
        attention_profile(args.n_res, args.n_seq, args.seed, smi)
        return
    if args.triangle_dropout:
        triangle_dropout_profile(args.n_res, args.n_seq, args.seed, smi)
        return
    if args.opm_layernorm:
        opm_layernorm_profile(args.n_res, args.n_seq, args.seed, smi)
        return
    if args.gate_softmax:
        gate_softmax_profile(args.n_res, args.n_seq, args.seed, smi,
                             args.parent)
        return
    if args.lm:
        for phase, (run, extra) in lm_runners(args.lm, PLANS[args.plan],
                                              args.seed).items():
            latency = _timed(run)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = _timed(run)
            report(prof, wall, {"device": smi, "phase": phase,
                                "plan": args.plan}, latency, extra, args.top)
        return
    cfg = dataclasses.replace(FULL, evoformer=dataclasses.replace(
        FULL.evoformer, remat_policy=args.remat_policy))
    ff = FastFold(cfg, plan=PLANS[args.plan])
    if args.train:
        params = ff.init(seed=args.seed)
    else:
        tree = randomize_tree(params_to_numpy(ff.init(seed=args.seed)),
                              args.seed + 1)
        params = params_from_numpy(tree, device="cuda")
    for n_res in args.n_res:
        batch = next(protein_batches(batch=1, n_seq=args.n_seq, n_res=n_res,
                                     seed=args.seed + 2)).as_dict()
        if args.train:
            run, extra = train_runner(ff, params, batch, args.seed)
        else:
            run, extra = serve_runner(ff, params, batch)
        latency = _timed(run)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _timed(run)
        head = {"n_res": n_res, "n_seq": args.n_seq, "plan": args.plan}
        if args.train:
            head["remat_policy"] = args.remat_policy
        report(prof, wall, {"device": smi, **head,
                            "n_blocks": FULL.evoformer.n_blocks,
                            "n_recycle": FULL.n_recycle}, latency, extra,
               args.top)


if __name__ == "__main__":
    main()
