#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel built from ``src/repro_torch/csrc`` by nvcc;
  3. survey  — every distinct call the FULL-width main paths make to a
               kernel (shape, dtype, memory layout), recorded on a forward
               cut to one block for each served request's shape, under the
               default plan and under attention-oracle
               (``KernelPolicy(attention="oracle")``: every attention site
               materializes its scores and runs the fused softmax);
     dap nccl1 — the whole model under Dynamic Axial Parallelism on a
               world-size-1 NCCL group (its collectives and the Duality
               Async trigger/block pair): the FULL fold and one FULL training
               step equal to the same model with ``LocalDist`` to the bit;
     dap 2  — two processes sharing the card through a gloo group run the
               whole model under DAP at FULL widths cut to 16 blocks
               (``DAP2_BLOCKS``; each rank's kernels at the shard shapes
               recorded on one block first): the fold (n_recycle = 3) held
               against the single-process port at the same depth at 2e-2
               (it comes out equal to the bit), the step's loss and gradient
               norm at 1e-2, an fp32 point (2 blocks, n_recycle = 3) at
               1e-3 for the fold and every gradient, the ranks' states equal
               to the bit, each rank's launches, peak memory and bytes per
               collective (as ``block_collective_bytes`` models them). Two
               ranks on one card measure no DAP speed;
     tp 2   — the same two ranks then run the Evoformer stack's forward
               under the TP baseline, FULL widths cut to 2 blocks
               (``TP_BLOCKS``), against the local stack (bf16 at 2e-2,
               fp32 at 1e-3), 6 all-reduces a block;
  4. kernels — each kernel against its plain PyTorch version on the card, at
               every surveyed call and at edge cases, in fp32 and bf16, with
               the stated tolerances (and, for K4 to K7, controls the
               tolerance must reject); kernel, plain and library-call times
               (CUDA events, cold L2, median of 20 runs) beside the bound for
               the same work, where the library call of the triangle and OPM
               kernels is the cuBLAS composition the port ran before them,
               and that of the fused softmax ``torch.softmax`` on logits
               summed beforehand (its whole composition timed beside it);
  5. serve   — ``FastFold(FULL).serve`` on three requests at full width
               (48 blocks, n_recycle = 3) with every weight randomised from
               a seed, after an uncounted warm-up pass at each shape: outputs
               finite, launch counts equal to the count the config gives (no
               bias-dropout-add, no attention backward, no fused softmax);
               then the same under attention-oracle (its own counts set to 0
               first: the fused softmax 4 times a block, no flash attention),
               its fold latency beside the default path's;
  6. smoke   — one ``FastFold(SMOKE)`` request on the card under the default
               plan: its widths lie outside the attention, triangle and OPM
               kernels, so it runs the materialized branches (the fused
               softmax, LayerNorm and gating kernels), with the launch counts
               the config gives and fp32 parity with the CPU;
  7. parity  — the same model cut to 2 blocks and no recycling, in fp32, on
               every served request, once on the card (the kernels) and once
               with ``device="cpu"`` (the plain versions), held together,
               under the default plan, attention-oracle, triangle-oracle and
               oracle;
  8. train   — ``make_train_step(FastFold(FULL).loss_fn)`` on the port's own
               init: r = 256, s = 128, batch 1, bf16, n_recycle = 3, remat
               per block, dropout from a seeded generator; three steps, the
               first uncounted: losses and gradient norms finite, no skipped
               step, launch counts equal to the count the config gives, warm
               step time and peak device memory; then two steps (one
               uncounted) under attention-oracle, with its own counts;
     train dots — the same step under ``remat_policy="dots"`` (each
               checkpointed block keeps its matrix products): one uncounted
               step held against the first step above, one counted; launches
               equal to the config's count, step time and peak memory beside
               the nothing policy's;
     resume — crash-safe checkpoints at the same setting: steps 1-3 under a
               tracer, a checkpoint after step 1, an injected fault killing
               the save after step 2, the newest intact checkpoint restored
               bit for bit, steps 2-3 again from it and held against the
               first run; checkpoint bytes, save and restore seconds, and a
               schema-valid trace with one event a step;
  9. train parity — FULL width cut to 2 blocks, no recycling, no dropout,
               fp32, randomised weights, r = 128, s = 64: the gradient of
               every parameter on the card and with ``device="cpu"``, held
               together, under the default plan and under attention-oracle,
               each at the random point and at a point whose FAPE pair
               errors all lie below half the loss's clamp (``OFF_CLAMP``);
 10. long    — AutoChunk at long sequences, FULL widths cut to 2 blocks, no
               recycling, s = 128, bf16, through ``FastFold.forward``:
               (a) attention-oracle at r = 2048 on the card's own budget
               (its unchunked model exceeds the card), (b) the default plan
               at r = 2048, (c) attention-oracle at r = 1024 unchunked
               against AutoChunk at 30% of the unchunked modelled peak,
               (d) the default plan at r = 1024 with every knob at its
               smallest candidate against none; each fold's chunk plan,
               modelled peak with and without its chunks, measured peak
               (``max_memory_allocated``), seconds and launches (chunks
               counted), the model held within 2x of the measurement and
               the chunked outputs within 2e-2 of the unchunked;
 11. long kernels — K4 (one chunk of (a)), K5, K7 and K8 at the r = 2048
               shapes, whole on the card, held against their plain versions
               on a slice of rows.
 12. analysis — repro-lint over ``src/repro_torch`` (clean), then the
               contract matrix of ``repro_torch.analysis`` (five cells under
               the default and oracle presets) on two gloo ranks sharing the
               card: a line a row with its modeled bytes, each rank's
               allocator peak above what it held, the ratio, collectives per
               block and rank 0's launches (K1, K2 and K4 in the default
               plan's Evoformer cells, none under oracle); any violation
               fails the run;
 13. examples — each ``examples/torch_*.py`` once on the card at its
               smallest arguments, in its own process, the four side by
               side (the mini trainer twice: 2 steps with checkpoints, then
               a resume to step 3): each exits 0 and prints its key lines;
 14. roofline — (last) each FULL-width path timed above against the
               roofline of its work as ``roofline.analysis`` counts it on
               the card (FLOPs of its matrix products, HBM bytes of its
               ops' inputs and outputs, each fused op's own at its
               boundary), at one and two blocks or layers of each kind,
               extrapolated to the full depth: the folds at r = 256 and 384
               and the training step, each under the default plan and
               attention-oracle; the LM serve prefill (256 tokens) and
               decode call (4 slots) of musicgen-medium and qwen2-1.5b;
               the LM train step of qwen2-1.5b, musicgen-medium and
               xlstm-125m. Each line has the counted FLOPs and bytes,
               t_compute_s and t_memory_s against one H100's peaks, the
               measured seconds (reused, not timed again), roofline_share
               = max(t_compute, t_memory) / measured, which must lie in
               (0, 1], and mfu (the model's FLOPs: 6 N D or 2 N D for the
               LMs, AlphaFold's step counted without recomputation) and
               hfu (the executed count) over measured x 989e12. The parity
               phase's cut (2 blocks, fp32, default plan) is counted on
               the card and on the host's CPU: equal. And
               ``launch.dryrun``'s one-device peak of qwen2-1.5b's
               training step at 4 x 512 tokens is held within 2x either
               way of the lm train phase's measured peak.
     lm serve — (after smoke) the LM serving engine at full width, bf16
               compute on fp32 weights drawn on the card from a seed:
               musicgen-medium (48 layers, LayerNorm: K1 2 · 48 + 1 = 97
               times a forward) and qwen2-1.5b (28 layers, GQA, tied
               embeddings, RMSNorm: no kernel), each serving eight requests
               (prompts of 32-256 tokens from ``lm_batches``, 32 new tokens,
               greedy) in 4 slots of 512 rows, one of them under the oracle
               plan as a canary, after an uncounted warm-up request: every
               request done, K1's launches per prefill and per decode call
               97 under the default plan and 0 for the canary and qwen2, no
               other kernel; musicgen-medium's bf16 prefill logits of the
               default plan within 2e-2·max(1, max|oracle|) of the
               oracle's on its first 2 layers (the same weights), the
               plain LayerNorm with beta left out of one norm rejected,
               the 48-layer gap and the oracle's bf16-vs-fp32 gap printed;
               seconds per prefill, decode tokens/s, engine steps, peak
               memory beside the planner's model and the weights, the
               block plan, greedy agreement with sequential
               ``model_forward`` (printed, not gated); then musicgen-medium
               cut to 4 layers in fp32 (K1's loop path): a prefill and 4
               decode steps, default plan against oracle and the cache's
               logits against a recompute, within 1e-3. Then the MoE, MLA,
               hymba and xLSTM kinds at full width (``LM_FAMILIES``):
               xlstm-125m and hymba-1.5b (max_seq 1024, its window) whole,
               deepseek-moe-16b cut to 1 dense + 3 MoE layers,
               deepseek-v2-236b to 1 dense + 1 MoE layer, each serving the
               same eight requests: every request done, no kernel, a
               second run the same tokens; cut to one layer of each kind,
               fp32, a 128-token prefill and 4 decode steps against a
               recompute (MoE capacity raised to the tokens of a call) and
               a 32-token prefill and 2 steps against the port on the
               host's CPU, within 1e-3 (the smallest router top-k margin
               printed). The survey (3) records K1's calls at this phase's
               shapes, so phase 4 checks and times K1 there.
     lm train — decoder LM training through ``repro_torch.launch.train``
               (``make_train_step`` over ``lm_loss``, AdamW, fp32 master
               weights and moments, bf16 compute, each layer checkpointed)
               at full width and depth on fp32 weights drawn on the card:
               qwen2-1.5b, musicgen-medium and xlstm-125m, 3 steps each of
               batch 4 x 512 tokens from ``lm_batches``: losses and
               gradient norms finite, no skipped step, K1 4 · n_layers + 1
               launches a step on musicgen-medium (97 in the forward, 96 in
               the recompute) and none on the others, no other kernel; the
               median of steps 2-3, tokens/s, peak memory beside the train
               state's bytes, and whether two identical steps give the
               same bits (bit checksums of every leaf, printed, not gated).
               Then each cut to 2 layers (one of each kind for xlstm) at
               full width, batch 1 x 128, fp32: the loss and every
               gradient on the card against the port on the host's CPU
               within 1e-3; musicgen-medium's cut in bf16, the default
               plan (K1) against oracle within 2e-2 for the loss and every
               gradient, the plain LayerNorm with beta left out of one norm
               rejected, the 48-layer gap printed; and the trainer's
               command line once more, 2 steps
               of xlstm-125m with ``--trace``, read back by ``python -m
               repro_torch.obs report --strict``. The survey (3) records
               K1's call at the training shape.
The survey (3) also records every kernel call of one training step cut to
one block, under both plans, so phase 4 checks the training kernels at the
training shapes, and the DAP and TP phases' calls at their shapes.
The last two lines are the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that. It needs the repository's ``src/`` beside it and a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Tolerances, kernel vs plain version on the same inputs on the card:
# max|kernel - plain| <= TOL * max(1, max|plain|). fp32: the same function
# summed in another order (attention sums D and Skv terms in another order
# than the plain version's GEMMs; the triangle and OPM kernels sum k, s, C
# and C^2 terms in another order). bf16: one rounding of the output is
# 2**-8 relative, and attention rounds p before its PV product at a
# different point (unnormalised, see the kernel's note) than the plain
# version (normalised); the triangle's y and the OPM's ov are rounded to
# bf16 before their second product, so a sum landing on the other side of
# a rounding boundary moves the result by a bf16 ulp of an operand.
TOL = {
    "layer_norm": {"float32": 1e-5, "bfloat16": 1e-2},
    "bias_sigmoid_mul": {"float32": 1e-5, "bfloat16": 1e-2},
    "flash_attention_fwd": {"float32": 1e-4, "bfloat16": 2e-2},
    "triangle_mult": {"float32": 1e-4, "bfloat16": 2e-2},
    "outer_product_mean": {"float32": 1e-4, "bfloat16": 2e-2},
    "flash_attention_bwd": {"float32": 1e-4, "bfloat16": 2e-2},
    "bias_dropout_add": {"float32": 1e-4, "bfloat16": 1e-2},
    "fused_softmax": {"float32": 1e-5, "bfloat16": 2 ** -7},
}
# The fused softmax is held element by element, not to max(1, max|plain|):
# its outputs are ~1/C, far below such a limit. |kernel - plain| <=
# max(TOL * |plain|, SOFTMAX_ATOL) at every element. It sums a row in fp32
# in another order than the plain version (a few fp32 ulps) and rounds its
# output once to the dtype: a bf16 ulp is at most 2**-7 of the value. A row
# whose every logit is -inf is NaN in both (the reference's 0/0), at the
# same places. Each check also shows that the limit rejects the plain
# version with the mask or the bias left out, or with the rows masked by
# -1e9 written as 0.
SOFTMAX_ATOL = 1e-9
# The attention backward sums S*D terms in another order than the plain
# version's GEMMs and rounds each output once to the dtype (in bf16 it also
# rounds P and dS to bf16 as the operands of its tensor-core products, where
# the plain version keeps them fp32); the
# bias-dropout-add kernel computes the plain version's fp32 expression and
# rounds once.
# Attention's lse: an fp32 sum. The triangle's LN mean and inv: fp32 sums
# of products of the compute dtype's operands, so in bf16 one gated a
# element rounding to the neighbouring bf16 value moves them by up to a bf16
# ulp of that term, as it moves the output.
LSE_TOL = 1e-4
STATS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Whole forward, fp32, card (kernels) vs CPU (plain versions), 2 blocks:
# max|card - cpu| <= E2E_TOL * max(1, max|cpu|), coordinates taken over the
# real residues of a padded request.
E2E_TOL = 1e-3
# Training, fp32, card vs CPU, 2 blocks: every parameter's gradient within
# GRAD_TOL * max(1, max|cpu gradient|) of that leaf.
GRAD_TOL = 1e-3
# A second, well-conditioned point of that check. At random weights nearly
# every FAPE pair error of its input lies beyond the loss's 10 Å clamp, and
# a pair near the clamp jumps a gradient (structure.bb_update.w) when an
# activation moves by one ulp. Scaling the structure module's backbone
# update and the true positions by these factors brings every pair error
# below half the clamp, which the phase measures on the CPU and holds.
OFF_CLAMP = {"bb_update": 0.01, "pseudo_beta": 0.05}
FAPE_CLAMP = 10.0
# Resuming from a checkpoint, and the dots remat policy against nothing,
# bf16 at FULL width: losses and gradient norms within this relative
# difference of the uninterrupted run's, or of the nothing policy's.
RESUME_TOL = 1e-3
# The plans the script drives, by the name its lines use.
PLAN_NAMES = ("default", "attention-oracle", "triangle-oracle", "oracle")
# The path whose launches stand in a kernel's line: the default plan's
# serving for the inference kernels, its training step for the two that
# only training runs, serving under attention-oracle for the fused softmax.
KERNEL_PATHS = {"flash_attention_bwd": "train",
                "bias_dropout_add": "train",
                "fused_softmax": "serve attention-oracle"}


SOURCES = {
    "layer_norm": ("src/repro_torch/csrc/layer_norm.cu",
                   "src/repro/kernels/layer_norm.py:70"),
    "bias_sigmoid_mul": ("src/repro_torch/csrc/bias_sigmoid_mul.cu",
                         "src/repro/kernels/fused_elementwise.py:43"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention_fwd.cu",
                            "src/repro/kernels/flash_attention.py:128"),
    "triangle_mult": ("src/repro_torch/csrc/triangle_mult.cu",
                      "src/repro/kernels/triangle.py:149"),
    "outer_product_mean": ("src/repro_torch/csrc/outer_product_mean.cu",
                           "src/repro/kernels/triangle.py:424"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:469"),
    "bias_dropout_add": ("src/repro_torch/csrc/bias_dropout_add.cu",
                         "src/repro/kernels/fused_elementwise.py:73"),
    "fused_softmax": ("src/repro_torch/csrc/fused_softmax.cu",
                      "src/repro/kernels/fused_softmax.py:60"),
}


def plan_of(name: str):
    """The ExecutionPlan of one of ``PLAN_NAMES``."""
    from repro_torch.exec.plan import ExecutionPlan, KernelPolicy, preset

    if name == "attention-oracle":
        return ExecutionPlan(kernels=KernelPolicy(attention="oracle"))
    return preset(name)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """CUDA-event timing: warm-up, then the median of ``runs`` launches,
    each after a write of 64 MB that evicts the 50 MB L2, so every run
    finds its inputs in device memory as the main path does."""

    def __init__(self, torch, runs: int = 20, warmup: int = 3):
        self.torch = torch
        self.runs, self.warmup = runs, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.runs):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(cost) -> tuple[float, str]:
    """Least time for one call's work, its ``roofline.analysis`` cost (the
    one source of these bounds and of the paths' roofline): bytes over the
    memory rate, operations over the peak rate of their type; the larger
    one, in ms."""
    from repro_torch import device

    peak = {"float32": device.PEAK_FLOPS_FP32,
            "bfloat16": device.PEAK_FLOPS_BF16}
    t_mem = cost.bytes / device.HBM_BW * 1e3
    t_ops = cost.ops / peak[cost.dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def _entry_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled entry name,
    e.g. 'flash_bwd_dq_mma_kernel<32, 4>' or 'dq_kernel<float, 16>'. The
    identifier's length prefix may follow digits of the namespace's hash,
    so every suffix of every digit run is tried, and of the identifiers
    ending in '_kernel' the first to end, and of those the shortest, wins."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for i in range(len(run)):
            size = int(run[i:])
            name = mangled[m.end():m.end() + size]
            if (size and len(name) == size and name.endswith("_kernel")
                    and re.fullmatch(r"[a-z_][a-z0-9_]*", name)):
                found.append((m.end() + size, size, name))
    if not found:
        return mangled
    end, _, name = min(found)
    rest = mangled[end:]
    args = []
    i = 1 if rest.startswith("I") else len(rest)
    while i < len(rest) and rest[i] != "E":
        m = re.match(r"13__nv_bfloat16|L[ib](\d+)E|[fhix]", rest[i:])
        if m is None:
            break
        tok = m.group(0)
        args.append(_TEMPLATE_TYPES.get(tok) or (
            ("false", "true")[int(m.group(1))] if tok.startswith("Lb")
            else m.group(1)))
        i += len(tok)
    return f"{name}<{', '.join(args)}>" if args else name


# Itanium codes of the template arguments the kernels use.
_TEMPLATE_TYPES = {"13__nv_bfloat16": "bf16", "f": "float", "h": "uint8",
                   "i": "int", "x": "int64"}


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and static shared memory of each entry point, as
    nvcc -Xptxas -v reports them."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"entry": _entry_name(m.group(1))})
        elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                      r"spill loads", line)):
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def rel_err(got, want) -> tuple[float, float]:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    scale = max(1.0, w.abs().max().item() if w.numel() else 0.0)
    return err, err / scale


def elem_rel_err(got, want, tol: float) -> float:
    """max |got - want| / max(|want|, SOFTMAX_ATOL / tol) over the elements:
    at most ``tol`` exactly when every element is within max(tol * |want|,
    SOFTMAX_ATOL)."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / w.abs().clamp_min(SOFTMAX_ATOL / tol)).max().item()


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

REQUESTS = [
    ("r256_s128", dict(n_seq=128, n_res=256, seed=SEED + 2)),
    ("r200_padded_to_256", dict(n_seq=128, n_res=256, n_real=200,
                                seed=SEED + 3)),
    ("r384_s128", dict(n_seq=128, n_res=384, seed=SEED + 4)),
]


# The training step's shape: the paper's initial training crop.
TRAIN_SHAPE = dict(n_seq=128, n_res=256)


def train_batches(n: int, **kw) -> list[dict]:
    """``n`` training batches (batch 1) from a seed."""
    from repro_torch.data import protein_batches

    shape = dict(TRAIN_SHAPE, **kw)
    gen = protein_batches(batch=1, seed=SEED + 5, **shape)
    return [next(gen).as_dict() for _ in range(n)]


def _cut(cfg, n_blocks: int):
    return dataclasses.replace(
        cfg, n_recycle=0,
        evoformer=dataclasses.replace(cfg.evoformer, n_blocks=n_blocks))


def _layout(ts):
    """How q, k, v lie in memory: per storage, its size in elements and the
    (shape, stride, offset) of each view into it, in q, k, v order."""
    groups = {}
    for i, t in enumerate(ts):
        key = t.untyped_storage().data_ptr()
        numel = t.untyped_storage().nbytes() // t.element_size()
        groups.setdefault(key, [numel, []])[1].append(
            (i, tuple(t.shape), tuple(t.stride()), t.storage_offset()))
    return tuple((numel, tuple(views)) for numel, views in groups.values())


@contextlib.contextmanager
def recording_calls(seen: dict, where: list):
    """Within the scope, each distinct call ``ops`` makes to a kernel
    wrapper (shape, dtype, memory layout) is noted in ``seen[kernel]``
    under ``where[0]``; yields {gate layout: whether ``ops._bsm_fwd``'s
    inputs arrived contiguous}."""
    from repro_torch.kernels import ops

    for k in TOL:
        seen.setdefault(k, {})
    names = ("layer_norm_cuda", "bias_sigmoid_mul_cuda",
             "flash_attention_cuda", "fused_triangle_cuda", "fused_opm_cuda",
             "flash_attention_bwd_cuda", "bias_dropout_add_cuda",
             "fused_softmax_cuda")
    orig = tuple(getattr(ops, n) for n in names)

    def ln(x, gamma, beta, eps=1e-5):
        seen["layer_norm"].setdefault(
            (tuple(x.shape), str(x.dtype)[6:]), where[0])
        return orig[0](x, gamma, beta, eps)

    def bsm(g, bg, v):
        seen["bias_sigmoid_mul"].setdefault(
            (tuple(v.shape), str(v.dtype)[6:]), where[0])
        return orig[1](g, bg, v)

    def attn(q, k, v, bias, mask, scale, **kw):
        seen["flash_attention_fwd"].setdefault(
            (_layout((q, k, v)), None if bias is None else bias.shape[0],
             mask is not None, str(q.dtype)[6:]), where[0])
        return orig[2](q, k, v, bias, mask, scale, **kw)

    def tri(a_lin, ga, mask, b_full, *rest, **kw):
        # a_lin/ga lie in memory as column halves of one projection; the
        # mask of the incoming update is a transposed view.
        seen["triangle_mult"].setdefault(
            (tuple(a_lin.shape), a_lin.stride(), mask.stride(),
             b_full.shape[1], rest[3].shape[-1], str(a_lin.dtype)[6:]),
            where[0])
        return orig[3](a_lin, ga, mask, b_full, *rest, **kw)

    def opm(a, b_full, mask_a, mask_b, w, bias, **kw):
        seen["outer_product_mean"].setdefault(
            (tuple(a.shape), b_full.shape[2], w.shape[-1], str(a.dtype)[6:]),
            where[0])
        return orig[4](a, b_full, mask_a, mask_b, w, bias, **kw)

    def attn_bwd(q, k, v, out, do, lse, bias, mask, scale, need_dmask=False):
        # do is the contiguous cotangent; the mask never needs a gradient.
        seen["flash_attention_bwd"].setdefault(
            (_layout((q, k, v)), None if bias is None else bias.shape[0],
             mask is not None, str(q.dtype)[6:]), where[0])
        return orig[5](q, k, v, out, do, lse, bias, mask, scale, need_dmask)

    def bda(x, b, residual, keep, rate):
        seen["bias_dropout_add"].setdefault(
            (tuple(x.shape), None if keep is None else tuple(keep.shape),
             b is not None, None if keep is None else str(keep.dtype)[6:],
             rate, str(x.dtype)[6:]), where[0])
        return orig[6](x, b, residual, keep, rate)

    def softmax(x, bias, mask, scale):
        seen["fused_softmax"].setdefault(
            (tuple(x.shape), None if bias is None else bias.shape[0],
             mask is not None, scale, str(x.dtype)[6:]), where[0])
        return orig[7](x, bias, mask, scale)

    # Whether ``ops._bsm_fwd``'s ``g.contiguous()`` / ``v.contiguous()``
    # copy at a main-path call: the gate's inputs as they reach it.
    gate_layouts = {}
    bsm_fwd = ops._bsm_fwd

    def gate_fwd(g, bg, v, kernel):
        gate_layouts.setdefault(
            (tuple(v.shape), g.stride(), v.stride(), str(v.dtype)[6:]),
            g.is_contiguous() and v.is_contiguous())
        return bsm_fwd(g, bg, v, kernel)

    for n, fn in zip(names, (ln, bsm, attn, tri, opm, attn_bwd, bda, softmax)):
        setattr(ops, n, fn)
    ops._bsm_fwd = gate_fwd
    try:
        yield gate_layouts
    finally:
        for n, fn in zip(names, orig):
            setattr(ops, n, fn)
        ops._bsm_fwd = bsm_fwd


def survey_phase(torch, tree, batches):
    """Every distinct call the main paths make to a kernel, recorded by
    wrapping the wrappers ``ops`` calls (``recording_calls``): one
    FULL-width forward for each request shape, cut to one Evoformer block
    (every block hands its kernels the same shapes) and no recycling (every
    pass hands them the same shapes), then one training step of the same
    cut at the training shape (r = 256, s = 128) with dropout; each under
    the default plan and under attention-oracle. Returns {kernel:
    {signature: request name}}; these launches happen before the main
    paths' counts are set to 0."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.train import make_train_step
    from repro_torch.weights import params_from_numpy

    params = params_from_numpy(dict(tree, evoformer=_slice_tree(
        tree["evoformer"], 1)), device="cuda")
    seen = {}
    where = [None]
    metrics = {}
    with recording_calls(seen, where) as gate_layouts:
        for plan in ("default", "attention-oracle"):
            ff = FastFold(_cut(FULL, 1), plan=plan_of(plan))
            done = set()
            for (name, kw), batch in zip(REQUESTS, batches):
                if (kw["n_res"], kw["n_seq"]) in done:
                    continue
                done.add((kw["n_res"], kw["n_seq"]))
                where[0] = f"{name} {plan}"
                ff.forward(params, batch)
            where[0] = (f"train r{TRAIN_SHAPE['n_res']}_s{TRAIN_SHAPE['n_seq']}"
                        f" {plan}")
            init, step = make_train_step(ff.loss_fn)
            _, m = step(init(params), train_batches(1)[0],
                        torch.Generator(device="cuda").manual_seed(SEED))
            metrics[plan] = {"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"])}
        torch.cuda.synchronize()
    emit({"phase": "survey", "cut": {"n_blocks": 1, "n_recycle": 0},
          "train_step": metrics,
          "distinct_calls": {k: len(v) for k, v in seen.items()},
          "gate_layouts": len(gate_layouts),
          "gate_layouts_copied": sum(not c for c in gate_layouts.values())})
    return seen


def kernel_phase(torch, timer, seen):
    """Each kernel against its plain version at every signature the survey
    and the DAP and TP phases found, in fp32 and bf16 (timed in the main
    path's own dtype), then at the edge cases."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (bwd_groups,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_cuda,
                                                     fwd_groups)
    from repro_torch.kernels.fused_elementwise import (bias_dropout_add_cuda,
                                                       bias_sigmoid_mul_cuda)
    from repro_torch.kernels.fused_softmax import fused_softmax_cuda
    from repro_torch.kernels.layer_norm import layer_norm_cuda
    from repro_torch.kernels.triangle import fused_opm_cuda, fused_triangle_cuda
    from repro_torch.roofline import analysis as roof
    from repro_torch.timing import cold_device_ms, device_ms, host_us

    gen = torch.Generator(device="cuda")
    # The timing copies draw from their own generator, so that the checks'
    # inputs do not depend on which calls are timed.
    copies_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def own_inputs(kernel, case, dt):
        """Seed ``gen`` from the check's own (kernel, case, dtype) key, so
        that a check added or removed elsewhere moves no other check's
        inputs."""
        gen.manual_seed(SEED + zlib.crc32(f"{kernel}/{case}/{dt}".encode()))
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    other = {"float32": "bfloat16", "bfloat16": "float32"}

    def randn(shape, dtype="float32", scale=1.0, shift=0.0, g=None):
        x = torch.randn(shape, generator=g or gen, device="cuda") * scale + shift
        return x.to(dts[dtype])

    results = []

    def device_timing(fn, make_args, prefix=""):
        """``fn(*make_args())``'s device time from the profiler, after the
        L2 flush and on cold inputs (copies of the inputs cycled, 200 MB or
        more), and its host time a call."""
        args = make_args()
        cold, _ = cold_device_ms(fn, make_args)
        return {f"{prefix}device_ms": sum(device_ms(lambda: fn(*args),
                                                    timer.flush).values()),
                f"{prefix}cold_device_ms": cold,
                f"{prefix}host_us": host_us(lambda: fn(*args))}

    def record(kernel, case, dtype, shape, got, want, timing=None, extra=None,
               rel=None):
        """``rel``: the error as the kernel's rule measures it, where that
        is not ``rel_err``'s."""
        err, rel_max1 = rel_err(got, want)
        rel = rel_max1 if rel is None else rel
        ok = rel <= TOL[kernel][dtype]
        row = {"phase": "kernel", "kernel": kernel, "case": case,
               "dtype": dtype, "shape": list(shape), "max_abs_err": err,
               "max_rel_err": rel, "tol": TOL[kernel][dtype], "ok": ok}
        if extra:
            row.update(extra)
        if timing:
            row.update(timing)
        emit(row)
        results.append(row)
        if not ok:
            fail(f"{kernel} {case} {dtype}: error {rel:.3g} > {TOL[kernel][dtype]}")

    # --- K1 LayerNorm.
    def check_ln(case, shape, dt, main):
        own_inputs("layer_norm", case, dt)
        c = shape[-1]
        x = randn(shape, dt, 2.0, 0.5)
        gamma = randn((c,), "float32", 0.1, 1.0)
        beta = randn((c,), "float32", 0.1)
        got = layer_norm_cuda(x, gamma, beta)
        want = ref.layer_norm_ref(x, gamma, beta)
        timing = None
        if main:
            g_l, b_l = gamma.to(x.dtype), beta.to(x.dtype)
            t_b, by = bound(roof.layer_norm_cost(x, gamma, beta))
            timing = {
                "ms": timer(lambda: layer_norm_cuda(x, gamma, beta)),
                "plain_ms": timer(lambda: ref.layer_norm_ref(x, gamma, beta)),
                "library_ms": timer(lambda: F.layer_norm(x, (c,), g_l, b_l)),
                "bound_ms": t_b, "bound_by": by,
                **device_timing(layer_norm_cuda, lambda: (
                    randn(shape, dt, 2.0, 0.5, copies_gen), gamma, beta)),
                **device_timing(lambda x_, g_, b_: F.layer_norm(
                    x_, (c,), g_, b_), lambda: (
                    randn(shape, dt, 2.0, 0.5, copies_gen), g_l, b_l),
                    "library_")}
        record("layer_norm", case, dt, shape, got, want, timing,
               {"main_path": main})

    # --- K2 bias·sigmoid·mul. ``offset``: g and v are views that many
    # elements into their buffers (off the 16-byte vectors where it is not
    # a multiple of them: the scalar variant).
    def check_bsm(case, shape, dt, main, offset=0):
        own_inputs("bias_sigmoid_mul", case, dt)
        c = shape[-1]
        numel = 1
        for d in shape:
            numel *= d
        g = randn((numel + offset,), dt, 2.0)[offset:].view(shape)
        v = randn((numel + offset,), dt)[offset:].view(shape)
        bg = randn((c,), "float32")
        got = bias_sigmoid_mul_cuda(g, bg, v)
        want = ref.bias_sigmoid_mul_ref(g, bg, v)
        timing = None
        if main:
            bg_l = bg.to(g.dtype)
            t_b, by = bound(roof.bias_sigmoid_mul_cost(g, bg, v))
            timing = {
                "ms": timer(lambda: bias_sigmoid_mul_cuda(g, bg, v)),
                "plain_ms": timer(lambda: ref.bias_sigmoid_mul_ref(g, bg, v)),
                "library_ms": timer(lambda: torch.sigmoid(g + bg_l) * v),
                "bound_ms": t_b, "bound_by": by,
                **device_timing(bias_sigmoid_mul_cuda, lambda: (
                    randn(shape, dt, 2.0, g=copies_gen), bg,
                    randn(shape, dt, g=copies_gen))),
                **device_timing(lambda g_, b_, v_: torch.sigmoid(g_ + b_) * v_,
                                lambda: (randn(shape, dt, 2.0, g=copies_gen),
                                         bg_l, randn(shape, dt, g=copies_gen)),
                                "library_")}
        record("bias_sigmoid_mul", case, dt, shape, got, want, timing,
               {"main_path": main, "offset": offset})

    # --- K5 flash-attention forward. q/k/v are views laid out in memory as
    # the main path lays them out (column slices of the merged projection);
    # the key mask drops ~10% of keys and masks every key of n_masked rows,
    # as padded residues do.
    def attn_inputs(layout, nb, wm, n_masked, dt):
        qkv = [None] * 3
        for numel, views in layout:
            buf = randn((numel,), dt)
            for i, shape, stride, offset in views:
                qkv[i] = buf.as_strided(shape, stride, offset)
        q, k, v = qkv
        n, sq, h, d = q.shape
        skv = k.shape[1]
        bias = randn((nb, h, sq, skv), dt) if nb else None
        mask = None
        if wm:
            keep = torch.rand((n, skv), generator=gen, device="cuda") < 0.9
            keep[:n_masked] = False
            mask = torch.where(keep, 0.0, -1e9).float()
        return q, k, v, bias, mask

    def controls_rejected(kernel, case, dt, controls, want, err=rel_err):
        """Each control (the plain version with the mask or the bias left
        out) must lie outside the limit the kernel is held to: its error as
        ``err`` (the kernel's own measure) gives it, non-finite counting as
        rejected."""
        tol, out = TOL[kernel][dt], {}
        for cname, bad in controls.items():
            errs = [err(b, w)[1] for b, w in zip(bad, want)
                    if w is not None]
            worst = (float("nan") if any(e != e for e in errs)
                     else max(errs))
            out[cname] = worst if worst == worst and worst != float("inf") \
                else "non-finite"
            if worst <= tol:
                fail(f"{kernel} {case} {dt}: the limit {tol} does not reject "
                     f"the control '{cname}' ({worst:.3g})")
        return out

    def check_attn(case, layout, nb, wm, n_masked, dt, main, groups=None):
        own_inputs("flash_attention_fwd", case, dt)
        q, k, v, bias, mask = attn_inputs(layout, nb, wm, n_masked, dt)
        n, sq, h, d = q.shape
        skv = k.shape[1]
        scale = 1.0 / d ** 0.5
        rep = n // nb if nb else None
        g_used = groups or (fwd_groups(n, sq, skv, h, rep) if dt == "bfloat16"
                            else 1)
        out, lse = flash_attention_cuda(q, k, v, bias, mask, scale, groups)
        want, want_lse = ref.attention_ref(q, k, v, bias, mask, scale)
        lse_err, lse_rel = rel_err(lse, want_lse)
        if lse_rel > LSE_TOL:
            fail(f"flash_attention_fwd {case} {dt}: lse error {lse_rel:.3g}")
        controls = {}
        if wm:
            controls["mask left out"] = ref.attention_ref(q, k, v, bias, None,
                                                          scale)[:1]
        if nb:
            controls["bias left out"] = ref.attention_ref(q, k, v, None, mask,
                                                          scale)[:1]
        control_err = controls_rejected("flash_attention_fwd", case, dt,
                                        controls, (want,))
        del controls
        timing = None
        if main:
            # The library call takes (N, H, S, D) and one additive mask, so
            # bias and key mask are combined into one (N, H, Sq, Skv) tensor
            # beforehand (outside the timed region).
            qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            am = (mask.to(q.dtype).view(n, 1, 1, skv) if wm else
                  torch.zeros((n, 1, 1, skv), dtype=q.dtype, device="cuda"))
            if nb:
                am = (bias.view(nb, 1, h, sq, skv)
                      + am.view(nb, rep, 1, 1, skv)).reshape(n, h, sq, skv)
            t_b, by = bound(roof.attention_cost(q, k, v, bias=bias,
                                                mask=mask))
            timing = {
                "ms": timer(lambda: flash_attention_cuda(q, k, v, bias, mask,
                                                         scale, groups)),
                "plain_ms": timer(lambda: ref.attention_ref(q, k, v, bias,
                                                            mask, scale)),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=am, scale=scale)),
                "bound_ms": t_b, "bound_by": by}
        record("flash_attention_fwd", case, dt, (n, sq, skv, h, d), out, want,
               timing, {"main_path": main, "rep": rep, "bias": bool(nb),
                        "mask": wm, "fully_masked_rows": n_masked if wm else 0,
                        "groups": g_used, "lse_max_rel_err": lse_rel,
                        "control_rel_err": control_err})

    def strided(shape, stride, dt, scale=1.0):
        """A view of the given shape and strides into a random buffer."""
        numel = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
        return randn((numel,), dt, scale).as_strided(shape, stride)

    # --- K7 fused triangular multiplicative update. a_lin and ga lie in
    # memory as the main path lays them out (column halves of a merged
    # projection), and so does the mask (a transposed view for the incoming
    # update); masked_rows rows i of a are masked at every k.
    def check_tri(case, a_shape, a_stride, m_stride, nj, d, dt, main,
                  masked_rows=0):
        own_inputs("triangle_mult", case, dt)
        bsz, ni, nk, c = a_shape
        a_lin = strided(a_shape, a_stride, dt)
        ga = strided(a_shape, a_stride, dt, 2.0)
        keep = torch.rand((bsz, ni, nk), generator=gen, device="cuda") < 0.9
        keep[:, :masked_rows] = False
        mask = strided((bsz, ni, nk), m_stride, "float32")
        mask.copy_(keep.float())
        b_full = randn((bsz, nj, nk, c), dt)
        gamma, beta = randn((c,), "float32", 0.1, 1.0), randn((c,), "float32", 0.1)
        w_out = randn((c, d), "float32", c ** -0.5)
        b_out, g_bias = randn((d,), "float32", 0.1), randn((d,), "float32")
        g_lin = randn((bsz, ni, nj, d), dt, 2.0)
        args = (a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
                g_bias)
        out, mean, inv = fused_triangle_cuda(*args)
        want, want_mean, want_inv = ref.triangle_mult_ref(*args)
        stats = {}
        for name, got_s, want_s in (("mean", mean, want_mean),
                                    ("inv", inv, want_inv)):
            stats[f"{name}_max_rel_err"] = rel_err(got_s, want_s)[1]
            if stats[f"{name}_max_rel_err"] > STATS_TOL[dt]:
                fail(f"triangle_mult {case} {dt}: {name} error "
                     f"{stats[f'{name}_max_rel_err']:.3g}")
        # Controls the limits must reject: the plain version with the gate
        # left out (sigmoid(30) is 1 in fp32), with the mask left out, and
        # the LN statistics of the fully masked rows written as 0 (their
        # output alone does not show it: y is beta either way).
        controls = {
            "gate left out": ref.triangle_mult_ref(
                a_lin, torch.full_like(ga, 30.0), *args[2:])[:1],
            "mask left out": ref.triangle_mult_ref(
                a_lin, ga, torch.ones_like(mask), *args[3:])[:1]}
        if masked_rows:
            zeroed = want_inv.clone()
            zeroed[:, :masked_rows] = 0.0
            controls["masked rows' LN statistics written as 0"] = (
                want, want_mean, zeroed)
        control_err = controls_rejected(
            "triangle_mult", case, dt, controls, (want, want_mean, want_inv))
        del controls
        timing = None
        if main:
            # The library yardstick is the cuBLAS composition the port ran
            # before this kernel: einsum (permute + bmm), F.layer_norm,
            # F.linear and the gate, with the weights cast beforehand.
            tdt = dts[dt]
            g_l, be_l = gamma.to(tdt), beta.to(tdt)
            w_t, bo_l, gb_l = w_out.t().contiguous().to(tdt), b_out.to(tdt), g_bias.to(tdt)

            def composition():
                a = torch.sigmoid(ga) * a_lin * mask[..., None].to(tdt)
                o = torch.einsum("bikc,bjkc->bijc", a, b_full)
                y = F.layer_norm(o, (c,), g_l, be_l)
                return torch.sigmoid(g_lin + gb_l) * F.linear(y, w_t, bo_l)

            t_b, by = bound(roof.triangle_cost(*args))
            timing = {
                "ms": timer(lambda: fused_triangle_cuda(*args)),
                "plain_ms": timer(lambda: ref.triangle_mult_ref(*args)),
                "library_ms": timer(composition),
                "library_call": "cuBLAS composition: einsum (permute + bmm) "
                                "+ F.layer_norm + F.linear + gate",
                "bound_ms": t_b, "bound_by": by}
        record("triangle_mult", case, dt, (bsz, ni, nj, nk, c, d), out, want,
               timing, {"main_path": main, "a_stride": list(a_stride),
                        "mask_stride": list(m_stride),
                        "fully_masked_rows": masked_rows, **stats,
                        "control_rel_err": control_err})

    # --- K8 fused outer-product-mean. a and b are masked by the MSA mask,
    # which also masks n_masked MSA rows and the last residue entirely.
    def opm_inputs(a_shape, nj, d, dt, n_masked=0, g=None):
        bsz, ns, ni, c = a_shape
        nr = max(ni, nj)
        mask = (torch.rand((bsz, ns, nr), generator=g or gen, device="cuda")
                < 0.9).float()
        mask[:, :n_masked] = 0.0
        mask[..., nr - 1] = 0.0
        mask_a, mask_b = mask[..., :ni].contiguous(), mask[..., :nj].contiguous()
        tdt = dts[dt]
        a = randn(a_shape, dt, g=g) * mask_a[..., None].to(tdt)
        b_full = randn((bsz, ns, nj, c), dt, g=g) * mask_b[..., None].to(tdt)
        w = randn((c * c, d), dt, 1.0 / c, g=g)
        bias = randn((d,), "float32", g=g)
        return a, b_full, mask_a, mask_b, w, bias

    def check_opm(case, a_shape, nj, d, dt, main, n_masked=0):
        own_inputs("outer_product_mean", case, dt)
        bsz, ns, ni, c = a_shape
        tdt = dts[dt]
        args = opm_inputs(a_shape, nj, d, dt, n_masked)
        a, b_full, mask_a, mask_b, w, bias = args
        out = fused_opm_cuda(*args)
        want = ref.outer_product_mean_ref(*args)
        timing = None
        if main:
            # The library yardstick is the cuBLAS composition the port ran
            # before this kernel: einsum (permute + bmm) for the outer
            # product and the norm, the fp32 divide, then F.linear.
            w_t, b_l = w.t().contiguous(), bias.to(tdt)

            def composition():
                o = torch.einsum("bsic,bsjd->bijcd", a, b_full)
                norm = torch.einsum("bsi,bsj->bij", mask_a, mask_b)
                o = (o.float() / (norm[..., None, None] + 1e-3)).to(tdt)
                return F.linear(o.reshape(o.shape[:3] + (c * c,)), w_t, b_l)

            t_b, by = bound(roof.opm_cost(*args))
            timing = {
                "ms": timer(lambda: fused_opm_cuda(*args)),
                "plain_ms": timer(lambda: ref.outer_product_mean_ref(*args)),
                "library_ms": timer(composition),
                "library_call": "cuBLAS composition: einsum (permute + bmm) "
                                "+ fp32 divide + F.linear",
                "bound_ms": t_b, "bound_by": by,
                **device_timing(fused_opm_cuda, lambda: opm_inputs(
                    a_shape, nj, d, dt, n_masked, copies_gen)),
                "library_host_us": host_us(composition)}
            if dt == "bfloat16":
                # The same call with its s loop empty: the projection and
                # the store; the outer product is the rest.
                proj = device_timing(fused_opm_cuda, lambda: opm_inputs(
                    (bsz, 0, ni, c), nj, d, dt, g=copies_gen), "projection_")
                timing.update(proj, outer_product_device_ms=(
                    timing["device_ms"] - proj["projection_device_ms"]))
        record("outer_product_mean", case, dt, (bsz, ns, ni, nj, c, d), out,
               want, timing, {"main_path": main,
                              "fully_masked_rows": n_masked})

    # --- K6 flash-attention backward, from the forward kernel's own (out,
    # lse) on inputs laid out as the main path lays them out; the cotangent
    # is contiguous, as autograd hands it over.
    def check_attn_bwd(case, layout, nb, wm, n_masked, dt, main,
                       need_dmask=False, groups=None, bitwise=False):
        own_inputs("flash_attention_bwd", case, dt)
        q, k, v, bias, mask = attn_inputs(layout, nb, wm, n_masked, dt)
        n, sq, h, d = q.shape
        skv = k.shape[1]
        scale = 1.0 / d ** 0.5
        rep = n // nb if nb else None
        g_used = groups or (bwd_groups(n, sq, skv, h, rep) if dt == "bfloat16"
                            else 1)
        out, lse = flash_attention_cuda(q, k, v, bias, mask, scale)
        do = randn((n, sq, h, d), dt)
        args = (q, k, v, out, do, lse, bias, mask, scale)
        got = flash_attention_bwd_cuda(*args, need_dmask, groups)
        want = ref.attention_bwd_ref(q, k, v, do, out, lse, bias, mask, scale)

        def err(g, w):
            """``rel_err`` over every group, and over the groups whose keys
            are not all masked, the larger: a fully masked group's
            gradients are Skv times autodiff's (ROADMAP.md R4) and alone
            set max|w|, which would hold every other group to a limit far
            above its own size (and a control there to nothing)."""
            e = rel_err(g, w)
            if wm and n_masked and g.shape[0] == n:
                e = max(e, rel_err(g[n_masked:], w[n_masked:]),
                        key=lambda t: t[1])
            return e

        errs = {}
        for name, g, w in zip(("dq", "dk", "dv", "dbias", "dmask"), got, want):
            if g is not None:
                errs[name] = err(g, w)
        worst = max(errs, key=lambda e: errs[e][1])
        controls = {}
        if wm:
            controls["mask left out"] = ref.attention_bwd_ref(
                q, k, v, do, out, lse, bias, None, scale)[:3]
        if nb:
            controls["bias left out"] = ref.attention_bwd_ref(
                q, k, v, do, out, lse, None, mask, scale)[:3]
        control_err = controls_rejected("flash_attention_bwd", case, dt,
                                        controls, want[:3], err)
        del controls
        extra = {}
        if bitwise:
            # Deterministic: a second run gives the same bits.
            again = flash_attention_bwd_cuda(*args, need_dmask, groups)
            same = all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None)
            extra["bit_identical_rerun"] = same
            if not same:
                fail(f"flash_attention_bwd {case} {dt}: two runs differ")
        timing = None
        if main:
            # The least work: five S x S x D products (s, dp, dv, dq, dk);
            # the kernel recomputes s and dp in each of its sweeps.
            t_b, by = bound(roof.attention_bwd_cost(q, k, v, out, do, lse,
                                                    bias, mask, got))
            lib_ms, lib_call = sdpa_backward_ms(q, k, v, bias, mask, do, scale)
            timing = {
                "ms": timer(lambda: flash_attention_bwd_cuda(*args, need_dmask,
                                                             groups)),
                "plain_ms": timer(lambda: ref.attention_bwd_ref(
                    q, k, v, do, out, lse, bias, mask, scale)),
                "library_ms": lib_ms, "library_call": lib_call,
                "bound_ms": t_b, "bound_by": by}
        record("flash_attention_bwd", case, dt, (n, sq, skv, h, d),
               got[["dq", "dk", "dv", "dbias", "dmask"].index(worst)],
               want[["dq", "dk", "dv", "dbias", "dmask"].index(worst)],
               timing, {"main_path": main, "rep": rep, "bias": bool(nb),
                        "mask": wm, "dmask": need_dmask,
                        "fully_masked_rows": n_masked if wm else 0,
                        "groups": g_used, "worst_output": worst,
                        "max_rel_err_by_output": {
                            e: errs[e][1] for e in errs},
                        "control_rel_err": control_err, **extra},
               rel=errs[worst][1])

    def sdpa_backward_ms(q, k, v, bias, mask, do, scale):
        """The backward of F.scaled_dot_product_attention on (N, H, S, D)
        copies, the bias and key mask summed into one (N, H, Sq, Skv)
        additive mask beforehand: dq, dk, dv and, where there is a bias,
        the gradient of that summed mask (not reduced over the groups that
        share a bias). None, with the reason, where PyTorch refuses it."""
        n, sq, h, d = q.shape
        skv = k.shape[1]
        qb, kb, vb = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        am = (mask.to(q.dtype).view(n, 1, 1, skv) if mask is not None else
              torch.zeros((n, 1, 1, skv), dtype=q.dtype, device="cuda"))
        inputs = [qb, kb, vb]
        call = "backward of F.scaled_dot_product_attention: dq, dk, dv"
        if bias is not None:
            nb = bias.shape[0]
            am = (bias.view(nb, 1, h, sq, skv)
                  + am.view(nb, n // nb, 1, 1, skv)).reshape(n, h, sq, skv)
            am = am.detach().requires_grad_(True)
            inputs.append(am)
            call += " and d(bias + mask) at (N, H, Sq, Skv)"
        gb = do.transpose(1, 2).contiguous()
        try:
            out = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=am,
                                                 scale=scale)
            fn = lambda: torch.autograd.grad(out, inputs, gb, retain_graph=True)
            fn()
        except RuntimeError as e:
            return None, f"{call}: refused ({str(e).splitlines()[0][:160]})"
        return timer(fn), call

    # --- K3 bias + dropout + residual add, with the reduced keep mask
    # (shared along one axis) as the main path hands it over.
    def check_bda(case, shape, keep_shape, with_bias, keep_dt, rate, dt, main):
        own_inputs("bias_dropout_add", case, dt)
        x = randn(shape, dt)
        res = randn(shape, dt)
        b = randn((shape[-1],), "float32") if with_bias else None
        keep = None
        if keep_shape is not None:
            keep = torch.rand(keep_shape, generator=gen, device="cuda") < 1 - rate
            keep = keep.to(getattr(torch, keep_dt))
        got = bias_dropout_add_cuda(x, b, res, keep, rate)
        want = ref.bias_dropout_add_ref(x, b, res, keep, rate)
        timing = None
        if main:
            # The library yardstick: one torch.addcmul(residual, x, keep,
            # value=1/(1 - rate)), keep cast to x's dtype beforehand (the
            # main path passes no bias).
            keep_l = keep.to(x.dtype)
            t_b, by = bound(roof.bias_dropout_add_cost(x, b, res, rate, keep))
            timing = {
                "ms": timer(lambda: bias_dropout_add_cuda(x, b, res, keep, rate)),
                "plain_ms": timer(lambda: ref.bias_dropout_add_ref(
                    x, b, res, keep, rate)),
                "library_ms": timer(lambda: torch.addcmul(
                    res, x, keep_l, value=1.0 / (1.0 - rate))),
                "library_call": "torch.addcmul(residual, x, keep, "
                                "value=1/(1-rate))",
                "bound_ms": t_b, "bound_by": by}
        record("bias_dropout_add", case, dt, shape, got, want, timing,
               {"main_path": main, "keep_shape": keep_shape,
                "keep_dtype": keep_dt, "bias": with_bias, "rate": rate})

    # --- K4 fused softmax on (N, H, R, C) scores: the key mask drops ~10%
    # of keys, masks every key of n_masked rows with -1e9 (padded residues)
    # and of inf_rows rows with -inf.
    def check_softmax(case, shape, nb, wm, scale, dt, main, n_masked=2,
                      inf_rows=0):
        own_inputs("fused_softmax", case, dt)
        n, h, r, c = shape
        x = randn(shape, dt, 4.0)
        bias = randn((nb, h, r, c), dt) if nb else None
        mask = None
        if wm:
            keep = torch.rand((n, c), generator=gen, device="cuda") < 0.9
            mask = torch.where(keep, 0.0, -1e9).float()
            mask[:n_masked] = -1e9
            if inf_rows:
                mask[n - inf_rows:] = float("-inf")
        got = fused_softmax_cuda(x, bias, mask, scale)
        want = ref.softmax_ref(x, bias, mask, scale)
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            fail(f"fused_softmax {case} {dt}: NaN at other places than the "
                 "plain version's")
        tol = TOL["fused_softmax"][dt]
        want0 = want.masked_fill(nan, 0)
        rel = elem_rel_err(got.masked_fill(nan, 0), want0, tol)
        # Controls: wrong outputs the limit must reject wherever they differ
        # from the plain version at all.
        controls = {}
        if wm:
            controls["mask left out"] = ref.softmax_ref(x, bias, None, scale)
        if nb:
            controls["bias left out"] = ref.softmax_ref(x, None, mask, scale)
        if wm and n_masked and c > 1:
            controls["-1e9 rows written as 0"] = want.clone()
            controls["-1e9 rows written as 0"][:n_masked] = 0
        control_rel = {}
        for cname, bad in controls.items():
            bad = bad.masked_fill(nan, 0)
            if torch.equal(bad, want0):
                continue
            control_rel[cname] = elem_rel_err(bad, want0, tol)
            if control_rel[cname] <= tol:
                fail(f"fused_softmax {case} {dt}: the limit {tol} does not "
                     f"reject the control '{cname}' ({control_rel[cname]:.3g})")
        del controls
        timing = None
        rep = n // nb if nb else None
        if main:
            # The library call: torch.softmax alone on the fp32 logits, summed
            # beforehand (outside the timed region); the composition: the
            # same function in whole-tensor torch ops from x, bias and mask.
            def logits():
                acc = x.float() * scale
                if nb:
                    acc = (acc.view(nb, rep, h, r, c)
                           + bias.float()[:, None]).view(n, h, r, c)
                if wm:
                    acc = acc + mask.view(n, 1, 1, c)
                return acc

            pre = logits()
            t_b, by = bound(roof.softmax_cost(x, bias, mask))
            timing = {
                "ms": timer(lambda: fused_softmax_cuda(x, bias, mask, scale)),
                "plain_ms": timer(lambda: ref.softmax_ref(x, bias, mask,
                                                          scale)),
                "library_ms": timer(lambda: torch.softmax(pre, -1)),
                "library_call": "torch.softmax(fp32 logits, -1), the logits "
                                "summed beforehand",
                "composition_ms": timer(lambda: torch.softmax(
                    logits(), -1).to(x.dtype)),
                "bound_ms": t_b, "bound_by": by,
                **device_timing(lambda *a: fused_softmax_cuda(*a, scale),
                                lambda: (randn(shape, dt, 4.0, g=copies_gen),
                                         None if bias is None else
                                         bias.clone(),
                                         None if mask is None else
                                         mask.clone())),
                "library_host_us": host_us(lambda: torch.softmax(pre, -1))}
            del pre
        record("fused_softmax", case, dt, shape, got.masked_fill(nan, 0),
               want0, timing,
               {"main_path": main, "rep": rep, "bias": bool(nb), "mask": wm,
                "fully_masked_rows_1e9": n_masked if wm else 0,
                "fully_masked_rows_inf": inf_rows if wm else 0,
                "nan_rows": int(nan.any(-1).sum()),
                "error_rule": "max |kernel - plain| / max(|plain|, "
                              f"{SOFTMAX_ATOL} / tol), per element",
                "control_rel_err": control_rel}, rel=rel)

    # Every main-path signature in its own dtype (timed), then in the other
    # dtype where the main path has no such call itself.
    checks = {"layer_norm": check_ln, "bias_sigmoid_mul": check_bsm,
              "flash_attention_fwd": lambda case, *a: check_attn(
                  case, *a[:-2], 2, *a[-2:]),
              "triangle_mult": check_tri, "outer_product_mean": check_opm,
              "flash_attention_bwd": lambda case, *a: check_attn_bwd(
                  case, *a[:-2], 2, *a[-2:]),
              "bias_dropout_add": check_bda, "fused_softmax": check_softmax}
    bitwise_done = False
    for kernel, calls in seen.items():
        for sig, req in calls.items():
            if (kernel == "flash_attention_bwd" and sig[-1] == "bfloat16"
                    and not bitwise_done):
                # One main-path shape also shows that K6 is deterministic.
                check_attn_bwd(f"{req} main path", *sig[:-1], 2, sig[-1],
                               True, bitwise=True)
                bitwise_done = True
                continue
            checks[kernel](f"{req} main path", *sig, True)
        for sig, req in calls.items():
            sig2 = sig[:-1] + (other[sig[-1]],)
            if sig2 not in calls:
                checks[kernel](f"{req} main path, other dtype", *sig2, False)

    # Edge cases.
    def qkv_layout(n, sq, skv, h, d):
        s, w = max(sq, skv), 3 * h * d
        return ((n * s * w, ((0, (n, sq, h, d), (s * w, w, d, 1), 0),
                             (1, (n, skv, h, d), (s * w, w, d, 1), h * d),
                             (2, (n, skv, h, d), (s * w, w, d, 1), 2 * h * d))),)

    def misaligned_layout(n, s, h, d):
        """q, k, v in one buffer at an odd element offset, with an S stride
        of 3 H D + 2: neither the pointers nor the strides allow 16-byte
        copies, so the bf16 wrappers copy them first."""
        w = 3 * h * d + 2
        return ((n * s * w + 8, tuple(
            (i, (n, s, h, d), (s * w, w, d, 1), 1 + i * h * d)
            for i in range(3))),)

    for dt in dts:
        check_ln("odd_c100", (3, 7, 100), dt, False)
        check_ln("c384", (2, 50, 384), dt, False)
        check_bsm("2d", (1000, 72), dt, False)
        # The scalar variant: C % 8 != 0, and a view one element off the
        # 16-byte vectors; two vectors a thread at C = 384 (bf16).
        check_bsm("c12_scalar", (50, 12), dt, False)
        check_bsm("misaligned_view", (64, 256), dt, False, offset=1)
        check_bsm("c384", (40, 384), dt, False)
        # (case, N, Sq, Skv, H, D, B, mask, fully masked rows, G): Sq and
        # Skv off the 64-row tiles, Sq < 16, rep 1, rep > G, D 16 with G,
        # a bias slice too wide to stage; G None is the wrapper's choice.
        for case, n, sq, skv, h, d, nb, wm, nm, g in [
                ("ragged_skv200", 6, 64, 200, 4, 32, 2, True, 0, None),
                ("fully_masked_rows", 8, 100, 100, 4, 32, 2, True, 3, None),
                ("no_bias_no_mask", 4, 130, 130, 2, 32, 0, False, 0, None),
                ("head_dim16", 4, 40, 40, 2, 16, 4, False, 0, None),
                ("sq5_below_16", 4, 5, 9, 2, 32, 2, True, 1, 2),
                ("rep1", 3, 70, 90, 2, 32, 3, True, 1, None),
                ("rep16_g4_ragged", 16, 100, 70, 2, 32, 1, True, 2, 4),
                ("head_dim16_g4", 8, 70, 130, 2, 16, 2, True, 1, 4),
                ("bias_unstaged_skv600", 2, 20, 600, 1, 32, 1, True, 1, None)]:
            check_attn(case, qkv_layout(n, sq, skv, h, d), nb, wm, nm, dt,
                       False, g)
        check_attn("misaligned_views", misaligned_layout(4, 40, 2, 32), 2,
                   True, 1, dt, False)
        # (case, B, I, J, K, C, D, fully masked rows): ragged against the
        # 16-pixel tile, I != J, MINI widths, C != D; the contiguous layout.
        for case, bsz, ni, nj, nk, c, d, nm in [
                ("ragged_ijk", 1, 37, 45, 29, 128, 128, 3),
                ("mini_widths", 2, 24, 20, 33, 32, 32, 1),
                ("c_ne_d", 1, 16, 16, 40, 32, 128, 0)]:
            check_tri(case, (bsz, ni, nk, c),
                      (ni * nk * c, nk * c, c, 1), (ni * nk, nk, 1), nj, d,
                      dt, False, nm)
        # I, J and K all off the tiles, B = 2, laid out as the incoming
        # update lays them out: a_lin and ga column halves of a merged
        # projection, the mask a transposed view.
        bsz, ni, nj, nk, c = 2, 17, 130, 200, 128
        check_tri("off_tile_incoming_b2", (bsz, ni, nk, c),
                  (ni * nk * 2 * c, nk * 2 * c, 2 * c, 1), (ni * nk, 1, ni),
                  nj, c, dt, False, 2)
        # (case, B, S, I, J, C, D, fully masked MSA rows)
        for case, bsz, ns, ni, nj, c, d, nm in [
                ("ragged_sij", 1, 37, 21, 19, 32, 128, 2),
                ("mini_widths", 2, 40, 30, 26, 16, 32, 1),
                ("c16_d128", 1, 8, 20, 20, 16, 128, 0)]:
            check_opm(case, (bsz, ns, ni, c), nj, d, dt, False, nm)
        # (case, N, Sq, Skv, H, D, B, mask, fully masked rows, dmask, G):
        # the K5 cases, plus rep 1 (dbias from the dq sweep), the mask's
        # gradient, and a (Sq x 64) slice too wide to stage.
        for case, n, sq, skv, h, d, nb, wm, nm, dmask, g in [
                ("ragged_skv200", 6, 64, 200, 4, 32, 2, True, 0, False, None),
                ("fully_masked_rows", 8, 100, 100, 4, 32, 2, True, 3, True,
                 None),
                ("no_bias_no_mask", 4, 130, 130, 2, 32, 0, False, 0, False,
                 None),
                ("head_dim16", 4, 40, 40, 2, 16, 4, False, 0, False, None),
                ("rep1_dbias_fused", 3, 70, 90, 2, 32, 3, True, 1, True, None),
                ("sq5_below_16", 4, 5, 9, 2, 32, 2, True, 1, True, 2),
                ("rep16_g4_ragged", 16, 100, 70, 2, 32, 1, True, 2, True, 4),
                ("head_dim16_g4", 8, 70, 130, 2, 16, 2, True, 1, False, 4),
                ("bias_unstaged_skv600", 2, 20, 600, 1, 32, 1, True, 1, True,
                 None),
                ("bias_unstaged_sq600", 2, 600, 40, 1, 32, 1, True, 1, True,
                 None)]:
            check_attn_bwd(case, qkv_layout(n, sq, skv, h, d), nb, wm, nm,
                           dt, False, dmask, g, bitwise=(case == "rep16_g4_ragged"))
        check_attn_bwd("misaligned_views", misaligned_layout(4, 40, 2, 32), 2,
                       True, 1, dt, False, True)
        # (case, shape, keep shape, bias, keep dtype, rate)
        for case, shape, kshape, wb, kdt, rate in [
                ("bias_no_dropout", (2, 9, 40, 64), None, True, None, 0.0),
                ("bias_shared_axis1_uint8", (1, 7, 33, 128), (1, 1, 33, 128),
                 True, "uint8", 0.25),
                ("shared_axis2_bool", (1, 33, 7, 256), (1, 33, 1, 256), False,
                 "bool", 0.15),
                ("full_mask_3d", (5, 11, 16), (5, 11, 16), True, "float32",
                 0.5)]:
            check_bda(case, shape, kshape, wb, kdt, rate, dt, False)
        # (case, (N, H, R, C), B, mask, -1e9 rows, -inf rows): no bias, no
        # mask, rep 1, C = 1, ragged C = 200 (vectors predicated) and 999
        # (one element at a time), 1025, 3000 and 16384 (block per row),
        # rows masked with -1e9 and with -inf, runs of rows that cross an n
        # (H*R = 15, two rows a warp at C = 128), 16 lanes a row at C = 384.
        for case, shape, nb, wm, nm, ni in [
                ("no_bias", (8, 4, 64, 128), 0, True, 2, 0),
                ("no_mask", (6, 2, 50, 96), 3, False, 0, 0),
                ("rep1", (4, 2, 40, 256), 4, True, 1, 0),
                ("c1", (4, 2, 8, 1), 2, True, 1, 1),
                ("c200_ragged", (6, 2, 30, 200), 2, True, 2, 0),
                ("c999_odd", (3, 2, 8, 999), 1, True, 1, 0),
                ("c3000_block_per_row", (2, 2, 8, 3000), 2, True, 1, 0),
                ("c16384", (2, 1, 4, 16384), 1, True, 1, 0),
                ("masked_rows_1e9", (8, 2, 16, 256), 2, True, 4, 0),
                ("masked_rows_inf", (8, 2, 16, 256), 2, True, 0, 3),
                ("c128_runs_cross_n", (7, 3, 5, 128), 7, True, 1, 1),
                ("c384_16_lanes", (6, 2, 30, 384), 2, True, 1, 1),
                ("c1025_block_per_row", (2, 2, 4, 1025), 1, True, 1, 0)]:
            check_softmax(case, shape, nb, wm, 32 ** -0.5, dt, False, nm, ni)
    return results


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

# The Evoformer sites each plan sends to their fused kernels, and the widths
# those kernels take on the card (HEAD_DIMS in kernels/flash_attention.py,
# TRI_WIDTHS, OPM_C and OPM_D in kernels/triangle.py). They are stated here
# apart from ``ops.fused_*_supported``, which choose the model's branches,
# so that the expected counts hold those choices rather than follow them.
PLAN_FUSED_SITES = {"default": ("attention", "triangle", "opm"),
                    "attention-oracle": ("triangle", "opm"),
                    "triangle-oracle": ("attention",),
                    "oracle": ()}


def _fused(cfg, plan: str) -> dict[str, bool]:
    """Which Evoformer sites take their fused kernel on the card under
    ``plan`` at the config's widths."""
    evo = cfg.evoformer
    fits = {"attention": evo.head_dim in (16, 32),
            "triangle": (evo.tri_mult_dim in (32, 128)
                         and evo.d_pair in (32, 128)),
            "opm": evo.opm_dim in (16, 32) and evo.d_pair in (32, 128)}
    return {site: site in PLAN_FUSED_SITES[plan] and fit
            for site, fit in fits.items()}


# Fixed facts of FULL (48 blocks, 3 recycles), held beside the counts that
# expected_launches derives: per request of each serving plan and per
# training step under attention-oracle.
FULL_FACTS = {
    ("serve", "default"): {
        "layer_norm": 2000, "bias_sigmoid_mul": 768,
        "flash_attention_fwd": 768, "triangle_mult": 384,
        "outer_product_mean": 192, "fused_softmax": 0},
    ("serve", "attention-oracle"): {
        "layer_norm": 2000, "bias_sigmoid_mul": 768,
        "flash_attention_fwd": 0, "triangle_mult": 384,
        "outer_product_mean": 192, "fused_softmax": 768},
    ("train", "attention-oracle"): {
        "fused_softmax": 960, "flash_attention_fwd": 0,
        "flash_attention_bwd": 0},
}


def check_facts(what: str, plan: str, counts: dict) -> None:
    facts = FULL_FACTS.get((what, plan), {})
    off = {k: (counts[k], n) for k, n in facts.items() if counts[k] != n}
    if off:
        fail(f"{what} {plan}: launches (got, fixed) {off}")


def _chunks(groups: int, chunk: int) -> int:
    """Sequential chunks of one attention site of ``groups`` groups under
    ``inference_chunk = chunk``: one where the chunk does not divide."""
    return groups // chunk if chunk and chunk < groups and groups % chunk == 0 \
        else 1


def expected_launches(cfg, passes: int, plan: str = "default",
                      shape: tuple[int, int] | None = None) -> dict[str, int]:
    """Launches per forward from the config and the plan: per Evoformer
    block 10 LayerNorms; per attention site and chunk (``inference_chunk``
    over the site's groups: s at the MSA row, r at the MSA column and the
    two triangle sites; ``shape`` = (s, r), needed where the knob is set)
    one output gate and the flash attention, or the fused softmax where the
    site is materialized; per triangle update the fused triangle kernel,
    or, materialized, its output LayerNorm and gate; per OPM the fused OPM
    kernel (materialized: none); per pass 2 LayerNorms in recycling and
    2 + 2 per iteration in the structure module. The oracle plan launches
    nothing."""
    if plan == "oracle":
        return dict.fromkeys(TOL, 0)
    evo = cfg.evoformer
    nb, ni = evo.n_blocks, cfg.structure.n_iterations
    f = _fused(cfg, plan)
    tri_ln = 0 if f["triangle"] else 2
    attn = 4
    if evo.inference_chunk:
        s, r = shape
        attn = (_chunks(s, evo.inference_chunk)
                + 3 * _chunks(r, evo.inference_chunk))
    return {"layer_norm": passes * ((10 + tri_ln) * nb + 2 + 2 + 2 * ni),
            "bias_sigmoid_mul": passes * (attn + tri_ln) * nb,
            "flash_attention_fwd": passes * attn * nb * f["attention"],
            "triangle_mult": passes * 2 * nb * f["triangle"],
            "outer_product_mean": passes * nb * f["opm"],
            "flash_attention_bwd": 0, "bias_dropout_add": 0,
            "fused_softmax": passes * attn * nb * (not f["attention"])}


def expected_train_launches(cfg, plan: str = "default") -> dict[str, int]:
    """Launches per training step from the config: n_recycle no-grad passes
    and the grad pass, each a forward (with the 6 dropout residual adds of a
    block on K3); then the backward recomputes every Evoformer block (its
    kernels run once more, the structure module's do not) and runs one
    attention backward per fused attention of the grad pass."""
    passes = cfg.n_recycle + 1
    nb = cfg.evoformer.n_blocks
    fwd = expected_launches(cfg, passes, plan)
    block = expected_launches(
        dataclasses.replace(cfg, structure=dataclasses.replace(
            cfg.structure, n_iterations=0)), 1, plan)
    block["layer_norm"] -= 4          # recycling and structure LNs
    out = {k: fwd[k] + block[k] for k in fwd}
    out["bias_dropout_add"] = (passes + 1) * 6 * nb
    out["flash_attention_bwd"] = 4 * nb * _fused(cfg, plan)["attention"]
    return out


def init_phase(torch):
    """The port's own init, then every leaf randomised from a seed, so no
    zero-initialised projection hides a kernel; and the requests' batches."""
    from repro_torch.configs import FULL
    from repro_torch.data import protein_batches
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_to_numpy, randomize_tree

    t0 = time.perf_counter()
    tree = randomize_tree(params_to_numpy(FastFold(FULL).init(seed=SEED)),
                          SEED + 1)
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "weights": "port init, every leaf randomised from seed "
                     f"{SEED + 1}", "n_params": sum(
              v.size for v in _leaves(tree))})
    batches = [next(protein_batches(batch=1, **kw)).as_dict()
               for _, kw in REQUESTS]
    return tree, batches


def serve_phase(torch, tree, batches, plan: str = "default",
                baseline: dict | None = None):
    """``FastFold(FULL, plan=...)`` serving the requests after a warm-up
    pass per shape, the launch counts set to 0 just before the counted
    requests and read just after. ``baseline``: the default plan's
    latencies, printed beside this plan's."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.kernels import _build
    from repro_torch.weights import params_from_numpy

    ff = FastFold(FULL, plan=plan_of(plan))
    params = params_from_numpy(tree, device="cuda")
    # Warm-up, outside the timed and counted run: one pass (n_recycle = 0)
    # at each request shape grows the allocator's pools and loads cuBLAS.
    warm = {}
    for (name, kw), batch in zip(REQUESTS, batches):
        key = f"r{kw['n_res']}_s{kw['n_seq']}"
        if key not in warm:
            t0 = time.perf_counter()
            ff.forward(params, batch, n_recycle=0)
            torch.cuda.synchronize()
            warm[key] = time.perf_counter() - t0
    emit({"phase": "warmup", "plan": plan, "n_recycle": 0, "seconds": warm})

    per_request = expected_launches(FULL, FULL.n_recycle + 1, plan)
    latencies = {}
    torch.cuda.synchronize()
    _build.reset_launches()                      # the main path starts here
    before = dict.fromkeys(per_request, 0)
    for (name, kw), batch in zip(REQUESTS, batches):
        t0 = time.perf_counter()
        (out,) = ff.serve(params, [batch])
        torch.cuda.synchronize()
        latencies[name] = time.perf_counter() - t0
        counts = {k: _build.LAUNCHES[k] - before[k] for k in per_request}
        before = {k: _build.LAUNCHES[k] for k in per_request}
        r, s = kw["n_res"], kw["n_seq"]
        shapes = {"coords": (1, r, 3), "msa_logits": (1, s, r, 23),
                  "distogram_logits": (1, r, r, 64)}
        finite = all(bool(torch.isfinite(out[k].float()).all())
                     for k in shapes)
        shapes_ok = all(tuple(out[k].shape) == v for k, v in shapes.items())
        row = {"phase": "serve", "plan": plan, "request": name, "n_res": r,
               "n_seq": s, "n_real": kw.get("n_real", r),
               "n_recycle": FULL.n_recycle,
               "n_blocks": FULL.evoformer.n_blocks,
               "latency_s": latencies[name]}
        if baseline is not None:
            row["default_plan_latency_s"] = baseline[name]
        row.update({"launches": counts, "expected_launches": per_request,
                    "finite": finite, "shapes_ok": shapes_ok,
                    "max_abs_coords": out["coords"].abs().max().item()})
        emit(row)
        if not (finite and shapes_ok):
            fail(f"serve {plan} {name}: outputs not finite or misshapen")
        if counts != per_request:
            fail(f"serve {plan} {name}: launches {counts} != expected "
                 f"{per_request}")
        check_facts("serve", plan, counts)
    main_launches = {k: _build.LAUNCHES[k] for k in per_request}
    if any(main_launches[k] == 0 for k in per_request if per_request[k]):
        fail(f"a kernel of the {plan} serving path never launched: "
             f"{main_launches}")
    del params
    return main_launches, latencies


def smoke_phase(torch):
    """One ``FastFold(SMOKE)`` request on the card under the default plan,
    every weight randomised: its head dim (8) and triangle and OPM widths
    (16, 8) lie outside those kernels, so each site takes its materialized
    branch. Outputs finite, the launch counts the config gives (the fused
    softmax, no flash attention, triangle or OPM kernel), and the fp32
    output within E2E_TOL of the CPU's."""
    from repro_torch.configs import SMOKE
    from repro_torch.data import protein_batches
    from repro_torch.exec import FastFold
    from repro_torch.kernels import _build
    from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                     randomize_tree)

    tree = randomize_tree(params_to_numpy(
        FastFold(SMOKE, device="cpu").init(seed=SEED)), SEED + 7)
    batch = next(protein_batches(batch=1, n_seq=16, n_res=40, n_real=33,
                                 seed=SEED + 8)).as_dict()
    ff = FastFold(SMOKE, plan=plan_of("default"))
    params = params_from_numpy(tree)
    ff.forward(params, batch)                     # warm-up, not counted
    per_request = expected_launches(SMOKE, SMOKE.n_recycle + 1)
    torch.cuda.synchronize()
    _build.reset_launches()
    (out,) = ff.serve(params, [batch])
    torch.cuda.synchronize()
    counts = {k: _build.LAUNCHES[k] for k in per_request}
    finite = all(bool(torch.isfinite(out[k].float()).all())
                 for k in ("coords", "msa_logits", "distogram_logits"))
    outs = {}
    for dev in ("cuda", "cpu"):
        f32 = FastFold(SMOKE, device=dev, dtype=torch.float32,
                       plan=plan_of("default"))
        outs[dev] = f32.forward(params_from_numpy(tree, device=dev), batch)
    diffs = {}
    for k in ("coords", "distogram_logits", "msa_logits"):
        got, want = outs["cuda"][k].cpu(), outs["cpu"][k]
        if k == "coords":                # the real residues (see parity)
            got, want = got[:, :33], want[:, :33]
        diffs[k] = rel_err(got, want)[1]
    row = {"phase": "smoke", "config": "SMOKE", "plan": "default",
           "n_res": 40, "n_real": 33, "n_seq": 16, "launches": counts,
           "expected_launches": per_request, "finite": finite,
           "fp32_max_rel_diff_vs_cpu": diffs, "tol": E2E_TOL}
    # SMOKE's widths lie outside the flash attention, triangle and OPM
    # kernels: every site takes its materialized branch.
    materialized = (counts["fused_softmax"] > 0
                    and counts["flash_attention_fwd"] == 0
                    and counts["triangle_mult"] == 0
                    and counts["outer_product_mean"] == 0)
    row["materialized"] = materialized
    row["ok"] = (finite and counts == per_request and materialized
                 and max(diffs.values()) <= E2E_TOL)
    emit(row)
    if not row["ok"]:
        fail(f"SMOKE request on the card: {row}")


def train_phase(torch, plan: str = "default", n_steps: int = 3):
    """The training entry point at the paper's initial training setting:
    ``make_train_step(FastFold(FULL, plan=...).loss_fn)`` on the port's own
    init, bf16, remat per block, dropout from a seeded generator on the
    card. One uncounted warm-up step, then ``n_steps - 1`` counted steps."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.kernels import _build
    from repro_torch.train import make_train_step

    ff = FastFold(FULL, plan=plan_of(plan))
    init, step = make_train_step(ff.loss_fn)
    state = init(ff.init(seed=SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batches = train_batches(n_steps)
    per_step = expected_train_launches(FULL, plan)

    def run(batch):
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        vals = {k: float(v) for k, v in metrics.items()}    # synchronises
        torch.cuda.synchronize()
        return time.perf_counter() - t0, vals

    def checked(i, secs, vals, counts=None):
        ok = (all(map(lambda x: x == x and abs(x) != float("inf"),
                      (vals["loss"], vals["grad_norm"])))
              and vals["nonfinite_skips"] == 0.0)
        row = {"phase": "train", "plan": plan, "step": i,
               "counted": counts is not None, "step_s": secs, **vals,
               "ok": ok}
        if counts is not None:
            row.update({"launches": counts, "expected_launches": per_step})
        emit(row)
        if not ok:
            fail(f"train {plan} step {i}: loss or grad norm not finite, or "
                 "skipped")
        if counts is not None and counts != per_step:
            fail(f"train {plan} step {i}: launches {counts} != expected "
                 f"{per_step}")
        if counts is not None:
            check_facts("train", plan, counts)

    secs, vals = run(batches[0])                  # warm-up, not counted
    checked(0, secs, vals)
    first = {k: vals[k] for k in ("loss", "grad_norm")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                      # the main path starts here
    before = dict.fromkeys(per_step, 0)
    times = []
    for i, batch in enumerate(batches[1:], start=1):
        secs, vals = run(batch)
        counts = {k: _build.LAUNCHES[k] - before[k] for k in per_step}
        before = {k: _build.LAUNCHES[k] for k in per_step}
        times.append(secs)
        checked(i, secs, vals, counts)
    launches = {k: _build.LAUNCHES[k] for k in per_step}
    if any(launches[k] == 0 for k in per_step if per_step[k]):
        fail(f"a kernel of the {plan} training path never launched: "
             f"{launches}")
    peak = torch.cuda.max_memory_allocated()
    summary = {"phase": "train_summary", "plan": plan,
               "n_res": TRAIN_SHAPE["n_res"],
               "n_seq": TRAIN_SHAPE["n_seq"], "batch": 1, "dtype": "bfloat16",
               "n_blocks": FULL.evoformer.n_blocks,
               "n_recycle": FULL.n_recycle, "remat": True,
               "dropout": [FULL.evoformer.dropout_msa,
                           FULL.evoformer.dropout_pair],
               "warm_step_s": statistics.mean(times), "step_s": times,
               "peak_memory_bytes": peak, "peak_memory_gb": peak / 1e9,
               "launches_per_step": per_step, "step0": first}
    emit(summary)
    del state
    return launches, summary


def _full(remat_policy: str = "nothing"):
    from repro_torch.configs import FULL

    return dataclasses.replace(FULL, evoformer=dataclasses.replace(
        FULL.evoformer, remat_policy=remat_policy))


def train_dots_phase(torch, nothing: dict):
    """The training step of ``train_phase`` under ``remat_policy="dots"``
    (each checkpointed block keeps its matrix products): the same init,
    batches and dropout generator, one uncounted step, then one counted.
    Its first step is held against ``nothing``'s (the default plan's
    ``train_summary``) at RESUME_TOL; its launches must equal the config's
    count, as every kernel is still recomputed."""
    from repro_torch.exec import FastFold
    from repro_torch.kernels import _build
    from repro_torch.train import make_train_step

    cfg = _full("dots")
    ff = FastFold(cfg, plan=plan_of("default"))
    init, step = make_train_step(ff.loss_fn)
    state = init(ff.init(seed=SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batches = train_batches(2)
    per_step = expected_train_launches(cfg)
    rows = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()              # the counted step starts
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        vals = {k: float(metrics[k]) for k in ("loss", "grad_norm",
                                               "nonfinite_skips")}
        torch.cuda.synchronize()
        rows.append({"phase": "train_dots", "step": i, "counted": i == 1,
                     "step_s": time.perf_counter() - t0, **vals})
        emit(rows[-1])
    counts = {k: _build.LAUNCHES[k] for k in per_step}
    peak = torch.cuda.max_memory_allocated()
    rel = {k: abs(rows[0][k] - nothing["step0"][k]) / abs(nothing["step0"][k])
           for k in ("loss", "grad_norm")}
    row = {"phase": "train_dots_summary", "remat_policy": "dots",
           "plan": "default", "n_res": TRAIN_SHAPE["n_res"],
           "n_seq": TRAIN_SHAPE["n_seq"], "n_blocks": cfg.evoformer.n_blocks,
           "step_s": rows[1]["step_s"], "peak_memory_bytes": peak,
           "peak_memory_gb": peak / 1e9, "launches": counts,
           "expected_launches": per_step,
           "step0_rel_diff_vs_nothing": rel,
           "step0_bitwise_vs_nothing": {
               k: rows[0][k] == nothing["step0"][k] for k in rel},
           "nothing": {"warm_step_s": nothing["warm_step_s"],
                       "peak_memory_bytes": nothing["peak_memory_bytes"],
                       "peak_memory_gb": nothing["peak_memory_gb"]}}
    row["ok"] = (counts == per_step and max(rel.values()) <= RESUME_TOL
                 and all(r["nonfinite_skips"] == 0.0 for r in rows))
    emit(row)
    if counts != per_step:
        fail(f"train dots: launches {counts} != expected {per_step}")
    if not row["ok"]:
        fail(f"train dots: first step off the nothing policy's, or skipped: "
             f"{row}")
    del state
    return counts


def resume_phase(torch):
    """Crash-safe checkpoints and resume at the training setting of
    ``train_phase``, through the entry points a trainer calls
    (``scripts/torch_train_alphafold.py``): step k takes batch k and
    dropout masks from a generator seeded by k. Run A takes steps 1-3 under
    a tracer, saves after step 1, and saves after step 2 under an injected
    ``checkpoint.save`` fault, which must raise ``TransientDecodeFault``.
    ``latest_checkpoint`` must then give step 1's file, restored bit for bit
    to the state saved; run B takes steps 2-3 from it. B's losses and
    gradient norms must equal A's within RESUME_TOL (relative); the trace
    must be schema-valid with one ``train_step`` event a step."""
    import shutil
    import tempfile

    from repro_torch.exec import FastFold
    from repro_torch.layers.params import tree_leaves
    from repro_torch.obs import Tracer, use_tracer, validate_events
    from repro_torch.resilience import (FaultSpec, TransientDecodeFault,
                                        inject_faults)
    from repro_torch.train import instrument_train_step, make_train_step
    from repro_torch.train.checkpoint import (latest_checkpoint,
                                              restore_checkpoint,
                                              save_checkpoint)

    ff = FastFold(_full(), plan=plan_of("default"))
    init, train_step = make_train_step(ff.loss_fn)
    batches = train_batches(3)
    tracer = Tracer()

    def take(step, state, run, rows):
        k = int(state.step)
        masks = torch.Generator(device="cuda").manual_seed(k)
        t0 = time.perf_counter()
        with use_tracer(tracer):
            state, metrics = step(state, batches[k], masks)
        vals = {m: float(metrics[m]) for m in ("loss", "grad_norm",
                                               "nonfinite_skips")}
        torch.cuda.synchronize()
        rows[k + 1] = {"phase": "resume", "run": run, "step": k + 1,
                       "step_s": time.perf_counter() - t0, **vals}
        emit(rows[k + 1])
        return state

    ckdir = tempfile.mkdtemp(prefix="resume_", dir=ROOT / "build")
    try:
        a_rows, b_rows = {}, {}
        step_a = instrument_train_step(train_step)
        state = take(step_a, init(ff.init(seed=SEED)), "A", a_rows)
        saved = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(ckdir, 1, state)
        save_s = time.perf_counter() - t0
        state = take(step_a, state, "A", a_rows)
        try:
            with inject_faults(FaultSpec("transient", "checkpoint.save",
                                         step=2)):
                save_checkpoint(ckdir, 2, state)
        except TransientDecodeFault:
            crashed = True
        else:
            crashed = False
        state_a = take(step_a, state, "A", a_rows)
        del state
        latest = latest_checkpoint(ckdir)
        t0 = time.perf_counter()
        restored = restore_checkpoint(latest, saved)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(list(restored)),
                         tree_leaves(list(saved))))
        restored_equal = all(
            r.dtype == s.dtype and r.device == s.device and torch.equal(r, s)
            for r, s in pairs)
        nbytes = os.path.getsize(path)
        del saved, pairs
        step_b = instrument_train_step(train_step)
        state_b = restored
        for _ in range(2):
            state_b = take(step_b, state_b, "B", b_rows)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    leaves_a = tree_leaves(list(state_a))
    leaves_b = tree_leaves(list(state_b))
    bitwise = all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))
    max_param_diff = max(
        (a.float() - b.float()).abs().max().item()
        for a, b in zip(tree_leaves(state_a.params),
                        tree_leaves(state_b.params)))
    rel = {f"{k}_step{i}": abs(b_rows[i][k] - a_rows[i][k]) / abs(a_rows[i][k])
           for i in (2, 3) for k in ("loss", "grad_norm")}
    events = tracer.events_resolved()
    problems = validate_events(events)
    n_train = sum(e["kind"] == "train_step" for e in events)
    row = {"phase": "resume_summary", "plan": "default",
           "n_res": TRAIN_SHAPE["n_res"], "n_seq": TRAIN_SHAPE["n_seq"],
           "n_blocks": ff.config.evoformer.n_blocks,
           "fault": "transient at checkpoint.save, "
           "step 2", "fault_raised": crashed,
           "latest_checkpoint": os.path.basename(latest or ""),
           "restored_bitwise": restored_equal,
           "checkpoint_bytes": nbytes, "save_s": save_s,
           "restore_s": restore_s, "rel_diff_b_vs_a": rel, "tol": RESUME_TOL,
           "b_equals_a_bitwise": bitwise,
           "max_param_abs_diff_after_step3": max_param_diff,
           "trace": {"events": len(events), "train_step_events": n_train,
                     "steps_taken": len(a_rows) + len(b_rows),
                     "problems": problems[:5]}}
    row["ok"] = (crashed and row["latest_checkpoint"] == "ckpt_00000001.npz"
                 and restored_equal and max(rel.values()) <= RESUME_TOL
                 and not problems and n_train == len(a_rows) + len(b_rows))
    emit(row)
    if not row["ok"]:
        fail(f"resume: {row}")


def train_parity_phase(torch, tree, plan: str = "default",
                       point: str = "random"):
    """The kernel path against the plain path through the backward: the
    FULL-width model cut to 2 blocks and no recycling, fp32, no dropout,
    randomised weights, r = 128, s = 64; the gradient of every parameter
    on the card and on the CPU, both under ``plan``. ``point`` "off-clamp"
    scales the inputs as ``OFF_CLAMP`` says and holds its largest FAPE pair
    error below half the clamp, on the CPU."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.layers.params import tree_leaves, tree_map
    from repro_torch.weights import params_from_numpy

    n_blocks = 2
    cfg = _cut(FULL, n_blocks)
    cut = dict(tree, evoformer=_slice_tree(tree["evoformer"], n_blocks))
    batch = train_batches(1, n_res=128, n_seq=64)[0]
    pair_error = None
    if point == "off-clamp":
        cut, batch = _off_clamp(cut, batch)
        pair_error = _max_pair_error(torch, cut, batch, cfg)
    grads, losses, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        ff = FastFold(cfg, device=dev, dtype=torch.float32, plan=plan_of(plan))
        params = tree_map(lambda t: t.requires_grad_(True),
                          params_from_numpy(cut, device=dev))
        t0 = time.perf_counter()
        loss, _ = ff.train_loss(params, batch)
        leaves = tree_leaves(params)
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        losses[dev] = float(loss.detach())
        secs[dev] = time.perf_counter() - t0
    worst = (0.0, 0.0, -1)
    for i, (g, w) in enumerate(zip(grads["cuda"], grads["cpu"])):
        err, rel = rel_err(g, w)
        if rel >= worst[1]:
            worst = (err, rel, i)
    names = _leaf_names(params)
    row = {"phase": "train_parity_fp32", "plan": plan, "point": point,
           "cut": {"n_blocks": n_blocks, "n_recycle": 0}, "width": "FULL",
           "n_res": 128, "n_seq": 64, "dropout": False, "tol": GRAD_TOL,
           "leaves": len(grads["cpu"]), "loss": losses,
           "loss_rel_diff": abs(losses["cuda"] - losses["cpu"])
           / abs(losses["cpu"]),
           "worst_leaf": names[worst[2]], "worst_max_abs_diff": worst[0],
           "worst_max_rel_diff": worst[1], "seconds": secs,
           "ok": worst[1] <= GRAD_TOL and all(
               torch.isfinite(g).all() for g in grads["cuda"])}
    if pair_error is not None:
        row.update({"off_clamp": OFF_CLAMP, "max_pair_error_A": pair_error,
                    "fape_clamp_A": FAPE_CLAMP})
        row["ok"] &= pair_error < FAPE_CLAMP / 2
    emit(row)
    if not row["ok"]:
        fail(f"fp32 gradients of the kernel path and the plain path disagree "
             f"under {plan} at the {point} point: {names[worst[2]]} "
             f"{worst[1]:.3g} > {GRAD_TOL}, or a FAPE pair error "
             f"{pair_error} not below half the clamp")


def _off_clamp(tree, batch):
    """C1's well-conditioned point: the structure module's backbone update
    and the true positions scaled by ``OFF_CLAMP``."""
    st = dict(tree["structure"])
    st["bb_update"] = {k: v * OFF_CLAMP["bb_update"]
                       for k, v in st["bb_update"].items()}
    batch = dict(batch, pseudo_beta=batch["pseudo_beta"]
                 * OFF_CLAMP["pseudo_beta"])
    return dict(tree, structure=st), batch


def _max_pair_error(torch, tree, batch, cfg) -> float:
    """The largest FAPE pair error, in Å, over the final frames and every
    iteration of the structure module's trajectory: the plain path on the
    CPU, fp32, the training forward without dropout."""
    from repro_torch.core.alphafold import alphafold_forward
    from repro_torch.core.losses import _pairwise_local, true_frames_from_ca
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_from_numpy

    ff = FastFold(cfg, device="cpu", dtype=torch.float32)
    b = ff.batch_to_device(batch)
    with torch.no_grad():
        out = alphafold_forward(params_from_numpy(tree, device="cpu"), b,
                                ff.config, train=True)
    true_pos = b["pseudo_beta"]
    want = _pairwise_local(*true_frames_from_ca(true_pos), true_pos)
    worst = 0.0
    for rot, trans in [out["frames"], *zip(*out["traj"])]:
        err = (_pairwise_local(rot, trans, trans) - want).square().sum(-1)
        worst = max(worst, err.max().sqrt().item())
    return worst


def _leaf_names(tree, prefix=""):
    """Leaf paths of the port's parameter tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix[:-1]}[{i}].")]
    return [prefix[:-1]]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def parity_phase(torch, tree, batches, plans=PLAN_NAMES):
    """The kernel path against the plain path end to end: the same FULL-width
    model and every served request in fp32, on the card under each of
    ``plans`` and on the CPU. Only the depth is cut (2 blocks, no
    recycling), to keep the CPU runs short. The default plan is held
    against the CPU under the default plan; every other plan against the
    CPU under oracle (every op on its plain version, every site
    materialized), which is run once per request for all of them."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_from_numpy

    n_blocks = 2
    cfg = _cut(FULL, n_blocks)
    cut = dict(tree, evoformer=_slice_tree(tree["evoformer"], n_blocks))
    params = {dev: params_from_numpy(cut, device=dev)
              for dev in ("cuda", "cpu")}

    def ff(dev, plan):
        return FastFold(cfg, device=dev, dtype=torch.float32,
                        plan=plan_of(plan))

    cpu_plans = {p: "default" if p == "default" else "oracle" for p in plans}
    bad = []
    for (name, kw), batch in zip(REQUESTS, batches):
        cpu, cpu_secs = {}, {}
        for cp in dict.fromkeys(cpu_plans.values()):
            t0 = time.perf_counter()
            cpu[cp] = ff("cpu", cp).forward(params["cpu"], batch)
            cpu_secs[cp] = time.perf_counter() - t0
        for plan in plans:
            t0 = time.perf_counter()
            got_out = ff("cuda", plan).forward(params["cuda"], batch)
            torch.cuda.synchronize()
            secs = {"cuda": time.perf_counter() - t0,
                    "cpu": cpu_secs[cpu_plans[plan]]}
            want_out = cpu[cpu_plans[plan]]
            row = {"phase": "parity_fp32", "plan": plan,
                   "cpu_plan": cpu_plans[plan], "request": name,
                   "cut": {"n_blocks": n_blocks, "n_recycle": 0},
                   "width": "FULL", "n_res": kw["n_res"],
                   "n_seq": kw["n_seq"],
                   "n_real": kw.get("n_real", kw["n_res"]), "tol": E2E_TOL,
                   "seconds": secs}
            ok, real = True, row["n_real"]
            for k in ("coords", "distogram_logits", "msa_logits"):
                got, want = got_out[k].cpu(), want_out[k]
                if k == "coords" and real < row["n_res"]:
                    # The coordinates of padding residues are no part of the
                    # fold and are ill-conditioned in the model itself (the
                    # row's "cpu_sensitivity" measures it on the plain path
                    # alone): reported, not held.
                    row["coords_padding"] = dict(zip(
                        ("max_abs_diff", "max_rel_diff"),
                        rel_err(got[:, real:], want[:, real:])))
                    got, want = got[:, :real], want[:, :real]
                err, rel = rel_err(got, want)
                row[k] = {"max_abs_diff": err, "max_rel_diff": rel}
                ok &= rel <= E2E_TOL
            if real < row["n_res"] and plan == "default":
                row["cpu_sensitivity"] = _sensitivity(
                    ff("cpu", "default"), params["cpu"], batch,
                    cpu["default"], real)
            row["ok"] = ok
            emit(row)
            if not ok:
                bad.append(f"{name} {plan}")
    if bad:
        fail(f"fp32 kernel path and plain path disagree end to end: {bad}")


def _sensitivity(ff, params, batch, base, real):
    """How far the plain path's coordinates move, at the real and at the
    padding residues, when one weight changes by a relative 1e-6."""
    gamma = params["structure"]["ln_s"]["gamma"]
    saved = gamma.clone()
    gamma.mul_(1 + 1e-6)
    try:
        moved = (ff.forward(params, batch)["coords"] - base["coords"]).abs()
    finally:
        gamma.copy_(saved)
    return {"perturbation": "structure.ln_s.gamma * (1 + 1e-6)",
            "coords_real_max_abs_change": moved[:, :real].max().item(),
            "coords_padding_max_abs_change": moved[:, real:].max().item()}


def _slice_tree(tree, n):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, n) for k, v in tree.items()}
    return tree[:n]


# ---------------------------------------------------------------------------
# Phase 10: long sequences (AutoChunk)
# ---------------------------------------------------------------------------

LONG_SHAPE = dict(n_seq=128)
LONG_BLOCKS = 2
KNOBS = ("inference_chunk", "opm_chunk", "attn_kv_tile", "tri_k_tile",
         "opm_s_tile")
# The smallest candidate of each knob the planner has (memory/autochunk.py).
SMALLEST_KNOBS = dict(inference_chunk=1, opm_chunk=8, attn_kv_tile=128,
                      tri_k_tile=16, opm_s_tile=16)
# Modelled and measured peaks must agree within this factor both ways.
PEAK_MODEL_FACTOR = 2.0
# Chunked against unchunked folds, bf16: the module tolerance of the port.
CHUNK_TOL = 2e-2


def long_fold(torch, params, batch, kernels: str, memory: dict, label: str):
    """One FULL-width fold (2 blocks, no recycling, bf16) through
    ``FastFold.forward`` under the kernel plan ``kernels`` with the
    MemoryPolicy fields ``memory``: the AutoChunk plan it resolves (read
    with the same allocations the forward starts from), the modelled peak
    with and without its chunks, the measured peak above what was
    allocated before (``max_memory_allocated``, reset first), the seconds,
    and the launches against ``expected_launches`` with the chunks counted.
    Fails unless the outputs are finite and of the expected shapes, the
    absolute peak stays under the card's memory, and model and measurement
    agree within ``PEAK_MODEL_FACTOR``. Returns (row, outputs)."""
    from repro_torch.configs import FULL
    from repro_torch.core.alphafold import planned_evoformer
    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import use_plan
    from repro_torch.kernels import _build
    from repro_torch.memory.autochunk import (modeled_evoformer_peak,
                                              outside_block_bytes,
                                              site_branches)

    cfg = _cut(FULL, LONG_BLOCKS)
    plan = plan_of(kernels).with_memory(**memory)
    ff = FastFold(cfg, plan=plan)
    dev_batch = ff.batch_to_device(batch)
    b, s, r = dev_batch["msa"].shape
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with use_plan(plan):
        evo, chunks, budget = planned_evoformer(cfg, (b, s, r), device="cuda")
        branches = site_branches(evo, batch=b, n_seq=s, n_res=r,
                                 device="cuda", dtype=cfg.compute_dtype)
    outside = sum(outside_block_bytes(
        evo, batch=b, n_seq=s, n_res=r, dtype=cfg.compute_dtype).values())

    def model(e):
        return outside + modeled_evoformer_peak(
            e, batch=b, n_seq=s, n_res=r, dtype=cfg.compute_dtype, **branches)

    total = torch.cuda.get_device_properties(0).total_memory
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = ff.forward(params, dev_batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = {k: _build.LAUNCHES[k] for k in TOL}
    run_cfg = dataclasses.replace(cfg, evoformer=evo)
    want = expected_launches(run_cfg, 1, kernels, shape=(s, r))
    shapes = {"coords": (b, r, 3), "msa_logits": (b, s, r, 23),
              "distogram_logits": (b, r, r, 64)}
    finite = all(bool(torch.isfinite(out[k].float()).all()) for k in shapes)
    shapes_ok = all(tuple(out[k].shape) == v for k, v in shapes.items())
    unchunked = dataclasses.replace(evo, **dict.fromkeys(KNOBS, 0))
    measured = peak - base
    row = {"phase": "long", "case": label, "plan": kernels,
           "memory_policy": memory, "n_res": r, "n_seq": s,
           "cut": {"n_blocks": LONG_BLOCKS, "n_recycle": 0},
           "width": "FULL", "dtype": "bfloat16", "branches": branches,
           "chunk_plan": chunks.describe() if chunks else None,
           "knobs": {k: getattr(evo, k) for k in KNOBS},
           "card_total_bytes": total, "allocated_before_bytes": base,
           "planner_budget_bytes": budget, "outside_block_bytes": outside,
           "modeled_peak_bytes": model(evo),
           "modeled_peak_unchunked_bytes": model(unchunked),
           "measured_peak_bytes": measured, "max_memory_allocated": peak,
           "model_over_measured": model(evo) / measured,
           "seconds": secs, "launches": counts, "expected_launches": want,
           "finite": finite, "shapes_ok": shapes_ok}
    emit(row)
    if not (finite and shapes_ok):
        fail(f"long {label}: outputs not finite or misshapen")
    if peak > total:
        fail(f"long {label}: peak {peak} above the card's {total} bytes")
    if counts != want:
        fail(f"long {label}: launches {counts} != expected {want}")
    if not 1 / PEAK_MODEL_FACTOR <= row["model_over_measured"] \
            <= PEAK_MODEL_FACTOR:
        fail(f"long {label}: modelled peak {model(evo)} and measured "
             f"{measured} differ by more than {PEAK_MODEL_FACTOR}x")
    return row, out


def _agree(label, got, want, tol=CHUNK_TOL):
    """Every output of two folds within tol * max(1, max|want|)."""
    diffs = {}
    for k in ("coords", "msa_logits", "distogram_logits", "msa", "pair"):
        diffs[k] = rel_err(got[k].float(), want[k].float())[1]
    if max(diffs.values()) > tol:
        fail(f"long {label}: chunked and unchunked folds disagree {diffs}")
    return diffs


def long_phase(torch, tree):
    """AutoChunk on the card: FULL widths cut to 2 blocks (one block sets
    the peak), no recycling, batch 1, s = 128, bf16, weights from the seed.
    (a) attention-oracle at r = 2048 with the card's own budget, whose
    unchunked model exceeds the card; (b) the default plan at r = 2048;
    (c) attention-oracle at r = 1024 unchunked against AutoChunk at a
    budget of 30% of the unchunked modelled peak; (d) the default plan at
    r = 1024 with every knob at its smallest candidate against none.
    Returns the chunk size of (a), for the kernel checks at its shapes."""
    from repro_torch.data import protein_batches
    from repro_torch.weights import params_from_numpy

    params = params_from_numpy(dict(tree, evoformer=_slice_tree(
        tree["evoformer"], LONG_BLOCKS)), device="cuda")
    batches = {r: next(protein_batches(batch=1, n_res=r, seed=SEED + 9,
                                       **LONG_SHAPE)).as_dict()
               for r in (2048, 1024)}
    rows = {}
    rows["a"], out = long_fold(torch, params, batches[2048],
                               "attention-oracle", {}, "a_oracle_r2048")
    del out
    if not rows["a"]["modeled_peak_unchunked_bytes"] > \
            rows["a"]["card_total_bytes"]:
        fail("long a: the unchunked model fits the card; r = 2048 shows "
             "nothing")
    rows["b"], out = long_fold(torch, params, batches[2048], "default", {},
                               "b_default_r2048")
    del out
    whole, out_whole = long_fold(torch, params, batches[1024],
                                 "attention-oracle", {"auto_chunk": False},
                                 "c_oracle_r1024_unchunked")
    budget = int(0.3 * whole["modeled_peak_bytes"])
    chunked, out_chunked = long_fold(torch, params, batches[1024],
                                     "attention-oracle",
                                     {"hbm_budget": budget},
                                     "c_oracle_r1024_autochunk")
    diffs = _agree("c", out_chunked, out_whole)
    del out_whole, out_chunked
    ratio = chunked["measured_peak_bytes"] / whole["measured_peak_bytes"]
    emit({"phase": "long_compare", "case": "c_oracle_r1024",
          "hbm_budget": budget,
          "unchunked_measured_peak_bytes": whole["measured_peak_bytes"],
          "autochunk_measured_peak_bytes": chunked["measured_peak_bytes"],
          "peak_ratio": ratio, "memory_saved": 1 - ratio,
          "paper_claim": "over 80% saved",
          "unchunked_seconds": whole["seconds"],
          "autochunk_seconds": chunked["seconds"],
          "max_rel_diff": diffs, "tol": CHUNK_TOL})
    plain, out_plain = long_fold(torch, params, batches[1024], "default",
                                 {"auto_chunk": False},
                                 "d_default_r1024_no_knobs")
    small, out_small = long_fold(torch, params, batches[1024], "default",
                                 SMALLEST_KNOBS,
                                 "d_default_r1024_smallest_knobs")
    diffs = _agree("d", out_small, out_plain)
    del out_plain, out_small
    emit({"phase": "long_compare", "case": "d_default_r1024",
          "no_knobs_measured_peak_bytes": plain["measured_peak_bytes"],
          "smallest_knobs_measured_peak_bytes": small["measured_peak_bytes"],
          "no_knobs_seconds": plain["seconds"],
          "smallest_knobs_seconds": small["seconds"],
          "max_rel_diff": diffs, "tol": CHUNK_TOL})
    del params
    torch.cuda.empty_cache()
    return rows["a"]["knobs"]["inference_chunk"]


def long_kernel_phase(torch, timer, chunk: int):
    """K4, K5 (triangle and MSA-row sites), K7 and K8 at the r = 2048 main
    path's shapes and layouts (bf16; K4 on one chunk of ``chunk`` triangle groups of fold (a)), each
    whole on the card and held against its plain version on a slice of
    rows the plain version can hold: ms of the whole call beside its bound,
    the plain version's and the library call's ms on the slice."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_softmax import fused_softmax_cuda
    from repro_torch.kernels.triangle import fused_opm_cuda, fused_triangle_cuda
    from repro_torch.roofline import analysis as roof

    r, h, d, s, bf = 2048, 4, 32, LONG_SHAPE["n_seq"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def randn(shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def key_mask(n, c):
        keep = torch.rand((n, c), generator=gen, device="cuda") < 0.9
        keep[:, c - 100:] = False                    # padded residues
        return torch.where(keep, 0.0, -1e9).float()

    rows = []

    def record(kernel, case, shape, err, rel, ms, cost, plain_ms,
               library_ms, library_call, rows_held):
        t_b, by = bound(cost)
        row = {"phase": "long_kernel", "kernel": kernel, "case": case,
               "dtype": "bfloat16", "shape": list(shape), "max_abs_err": err,
               "max_rel_err": rel, "tol": TOL[kernel]["bfloat16"],
               "rows_held_against_plain": rows_held, "ms": ms,
               "bound_ms": t_b, "bound_by": by, "plain_ms_on_slice": plain_ms,
               "library_ms_on_slice": library_ms,
               "library_call": library_call}
        emit(row)
        rows.append(row)
        if rel > TOL[kernel]["bfloat16"]:
            fail(f"{kernel} {case}: error {rel:.3g} > "
                 f"{TOL[kernel]['bfloat16']}")

    # K5 at the triangle sites: q, k, v column slices of the merged
    # projection, (N = r groups, S = r, H, D); bias (1, H, r, r).
    n, held = r, 8
    qkv = randn((n, r, 3 * h * d))
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
               for i in range(3))
    bias, mask, scale = randn((1, h, r, r)), key_mask(n, r), d ** -0.5
    out, _ = flash_attention_cuda(q, k, v, bias, mask, scale)
    sl = (q[:held], k[:held], v[:held], bias, mask[:held], scale)
    want, _ = ref.attention_ref(*sl)
    err, rel = rel_err(out[:held], want)
    qb, kb, vb = (t.transpose(1, 2).contiguous() for t in sl[:3])
    am = (bias + mask[:held].to(bf).view(held, 1, 1, r))
    record("flash_attention_fwd", "r2048 triangle site", (n, r, r, h, d),
           err, rel, timer(lambda: flash_attention_cuda(q, k, v, bias, mask,
                                                        scale)),
           roof.attention_cost(q, k, v, bias=bias, mask=mask),
           timer(lambda: ref.attention_ref(*sl)),
           timer(lambda: F.scaled_dot_product_attention(
               qb, kb, vb, attn_mask=am, scale=scale)),
           "SDPA, bias and mask summed beforehand", held)
    del qkv, q, k, v, out, want, qb, kb, vb, am

    # K5 at the MSA-row site: (N = s sequences, S = r, H 8, D); the pair
    # bias (1, 8, r, r) shared by all s (rep = s).
    n, hr, held = s, 8, 4
    qkv = randn((n, r, 3 * hr * d))
    q, k, v = (qkv[..., i * hr * d:(i + 1) * hr * d].unflatten(-1, (hr, d))
               for i in range(3))
    rbias, mask = randn((1, hr, r, r)), key_mask(n, r)
    out, _ = flash_attention_cuda(q, k, v, rbias, mask, scale)
    sl = (q[:held], k[:held], v[:held], rbias, mask[:held], scale)
    want, _ = ref.attention_ref(*sl)
    err, rel = rel_err(out[:held], want)
    qb, kb, vb = (t.transpose(1, 2).contiguous() for t in sl[:3])
    am = (rbias + mask[:held].to(bf).view(held, 1, 1, r))
    record("flash_attention_fwd", "r2048 MSA-row site", (n, r, r, hr, d),
           err, rel, timer(lambda: flash_attention_cuda(q, k, v, rbias, mask,
                                                        scale)),
           roof.attention_cost(q, k, v, bias=rbias, mask=mask),
           timer(lambda: ref.attention_ref(*sl)),
           timer(lambda: F.scaled_dot_product_attention(
               qb, kb, vb, attn_mask=am, scale=scale)),
           "SDPA, bias and mask summed beforehand", held)
    del qkv, q, k, v, rbias, out, want, qb, kb, vb, am

    # K4 on one chunk of the triangle sites under attention-oracle:
    # (N = chunk groups, H, r, r) scores, bias (1, H, r, r).
    n, held = chunk, 4
    x, mask = randn((n, h, r, r), 4.0), key_mask(n, r)
    got = fused_softmax_cuda(x, bias, mask, scale)
    want = ref.softmax_ref(x[:held], bias, mask[:held], scale)
    tol = TOL["fused_softmax"]["bfloat16"]
    rel = elem_rel_err(got[:held], want, tol)
    pre = (x[:held].float() * scale + bias.float()
           + mask[:held].view(held, 1, 1, r))
    record("fused_softmax", f"r2048 triangle chunk of {n}", (n, h, r, r),
           rel_err(got[:held], want)[0], rel,
           timer(lambda: fused_softmax_cuda(x, bias, mask, scale)),
           roof.softmax_cost(x, bias, mask),
           timer(lambda: ref.softmax_ref(x[:held], bias, mask[:held], scale)),
           timer(lambda: torch.softmax(pre, -1)),
           "torch.softmax(fp32 logits, -1), the logits summed beforehand",
           held)
    del x, got, want, pre, bias

    # K7, outgoing: a_lin, ga the column halves of the merged projections.
    c, held = 128, 16
    ab, gg = randn((1, r, r, 2 * c)), randn((1, r, r, 2 * c), 2.0)
    a_lin, ga = ab[..., :c], gg[..., :c]
    tmask = (torch.rand((1, r, r), generator=gen, device="cuda")
             < 0.9).float()
    b_full, g_lin = randn((1, r, r, c)), randn((1, r, r, c), 2.0)
    f32 = dict(dtype=torch.float32)
    gamma, beta = randn((c,), 0.1, **f32) + 1, randn((c,), 0.1, **f32)
    w_out, b_out = randn((c, c), c ** -0.5, **f32), randn((c,), 0.1, **f32)
    g_bias = randn((c,), **f32)
    args = (a_lin, ga, tmask, b_full, gamma, beta, w_out, b_out, g_lin,
            g_bias)
    out, _, _ = fused_triangle_cuda(*args)
    sl = (a_lin[:, :held], ga[:, :held], tmask[:, :held], b_full, gamma,
          beta, w_out, b_out, g_lin[:, :held], g_bias)
    want = ref.triangle_mult_ref(*sl)[0]
    err, rel = rel_err(out[:, :held], want)
    g_l, be_l, w_t = gamma.to(bf), beta.to(bf), w_out.t().contiguous().to(bf)

    def composition():
        a = torch.sigmoid(sl[1]) * sl[0] * sl[2][..., None].to(bf)
        o = torch.einsum("bikc,bjkc->bijc", a, b_full)
        y = F.layer_norm(o, (c,), g_l, be_l)
        return torch.sigmoid(sl[8] + g_bias.to(bf)) * F.linear(
            y, w_t, b_out.to(bf))

    record("triangle_mult", "r2048 outgoing", (1, r, r, r, c, c), err, rel,
           timer(lambda: fused_triangle_cuda(*args)),
           roof.triangle_cost(*args),
           timer(lambda: ref.triangle_mult_ref(*sl)), timer(composition),
           "cuBLAS composition: einsum (permute + bmm) + F.layer_norm + "
           "F.linear + gate", held)
    del ab, gg, a_lin, ga, b_full, g_lin, out, args, sl, want

    # K8: a, b (1, s, r, 32) masked; w (32 * 32, 128).
    c, dz, held = 32, 128, 16
    omask = (torch.rand((1, s, r), generator=gen, device="cuda") < 0.9).float()
    a = randn((1, s, r, c)) * omask[..., None].to(bf)
    b_ = randn((1, s, r, c)) * omask[..., None].to(bf)
    w, obias = randn((c * c, dz), 1.0 / c), randn((dz,), **f32)
    out = fused_opm_cuda(a, b_, omask, omask, w, obias)
    sl = (a[:, :, :held].contiguous(), b_, omask[:, :, :held].contiguous(),
          omask, w, obias)
    want = ref.outer_product_mean_ref(*sl)
    err, rel = rel_err(out[:, :held], want)
    wl, bl = w.to(bf), obias.to(bf)

    def opm_composition():
        o = torch.einsum("bsic,bsjd->bijcd", sl[0], b_)
        norm = torch.einsum("bsi,bsj->bij", sl[2], omask)
        ov = (o / (norm[..., None, None] + 1e-3).to(bf))
        return ov.flatten(-2) @ wl + bl

    record("outer_product_mean", "r2048", (1, s, r, r, c, dz), err, rel,
           timer(lambda: fused_opm_cuda(a, b_, omask, omask, w, obias)),
           roof.opm_cost(a, b_, omask, omask, w, obias),
           timer(lambda: ref.outer_product_mean_ref(*sl)),
           timer(opm_composition),
           "cuBLAS composition: einsum + mask norm + matmul", held)
    del a, b_, out, sl, want
    torch.cuda.empty_cache()
    emit({"long_kernels": rows})
    return rows


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Dynamic Axial Parallelism and the TP baseline
# ---------------------------------------------------------------------------

# The fold and step under DAP against the single-process port on the card,
# bf16: each fold output within DAP_FOLD_TOL * max(1, max|port|), loss and
# gradient norm within DAP_STEP_RTOL relative. A rank's kernels give its
# shard of rows the whole call's rows to the bit, and the forward's
# collectives only move bytes, so the fold and the loss come out equal to
# the bit (a fold this deep at random weights moves by 0.1-0.4 of its
# coordinates for one differing rounding); the gradient norm moves with
# the order of the ranks' partial sums. The fp32 point (FULL widths,
# DAP_FP32_BLOCKS blocks, n_recycle = 3, no dropout): the fold and every
# gradient within E2E_TOL / GRAD_TOL. Two ranks share one card through
# host memory, so their phases run DAP2_BLOCKS and TP_BLOCKS of the 48
# blocks (depth cut, widths whole). TP's row-parallel products sum two
# rounded halves, so its bf16 stack differs from the local one by rounding
# that grows with depth (1.2-1.4e-2 at 2 blocks, 3.0-3.4e-2 at 16):
# TP_BLOCKS keeps it a check that DAP_FOLD_TOL can hold.
DAP_RANKS = 2
DAP2_BLOCKS = 16
TP_BLOCKS = 2
DAP_FOLD_TOL = 2e-2
DAP_STEP_RTOL = 1e-2
DAP_FP32_BLOCKS = 2
# Every spawned rank must finish within this, or the phase fails.
DAP_TIMEOUT_S = 420
# The fold outputs held together.
FOLD_KEYS = ("coords", "msa_logits", "distogram_logits")


def _depth(cfg, n_blocks: int):
    """``cfg`` with ``n_blocks`` Evoformer blocks, recycling kept."""
    return dataclasses.replace(cfg, evoformer=dataclasses.replace(
        cfg.evoformer, n_blocks=n_blocks))


def _gspmd_plan():
    """The default plan with the whole model under DAP on the default
    process group."""
    return plan_of("default").with_parallel(backend="gspmd")


def _digest(torch, tree) -> str:
    """One hash of every leaf's bytes, in tree order."""
    import hashlib

    from repro_torch.layers.params import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def _fold_and_step(torch, ff, params, batch, tbatch):
    """One fold of ``batch`` and one training step on ``tbatch`` (dropout
    from a generator seeded SEED on the card), each with the launch and
    collective counts set to 0 just before it and read just after, its
    seconds and its peak memory."""
    from repro_torch.core import dist as D
    from repro_torch.kernels import _build
    from repro_torch.train import make_train_step

    rec = {}
    for what in ("fold", "step"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        D.reset_collectives()
        t0 = time.perf_counter()
        if what == "fold":
            out = ff.forward(params, batch)
            rec["out"] = {k: out[k] for k in FOLD_KEYS}
            del out
        else:
            init, step = make_train_step(ff.loss_fn)
            state, m = step(init(params), tbatch,
                            torch.Generator(device="cuda").manual_seed(SEED))
            rec["state"] = state
            rec["loss"], rec["grad_norm"] = (float(m["loss"]),
                                             float(m["grad_norm"]))
        torch.cuda.synchronize()
        rec[what] = {"seconds": time.perf_counter() - t0,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {k: _build.LAUNCHES[k] for k in TOL},
                     "collectives": D.collectives()}
    return rec


def dap_nccl1_phase(torch, tree, batch):
    """The whole model under DAP on a world-size-1 NCCL group on the card
    (real NCCL collectives, the trigger/block pair), against the same model
    with ``LocalDist``: the FULL fold (48 blocks, n_recycle = 3, r = 256,
    s = 128, bf16, default plan) and one FULL training step. The products
    and kernels are the same, so the fold's outputs, the loss, the gradient
    norm and every parameter and optimizer moment after the step must be
    equal to the bit. Returns the launches."""
    import tempfile

    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_from_numpy

    params = params_from_numpy(tree, device="cuda")
    tbatch = train_batches(1)[0]
    t0 = time.perf_counter()
    local = _fold_and_step(torch, FastFold(FULL, plan=plan_of("default")),
                           params, batch, tbatch)
    with tempfile.TemporaryDirectory() as tmp:
        D.form_group(0, 1, os.path.join(tmp, "store"), backend="nccl",
                     device="cuda")
        try:
            dap = _fold_and_step(torch, FastFold(FULL, plan=_gspmd_plan()),
                                 params, batch, tbatch)
        finally:
            D.tdist.destroy_process_group()
    equal = {k: bool(torch.equal(dap["out"][k], local["out"][k]))
             for k in FOLD_KEYS}
    equal["loss"] = dap["loss"] == local["loss"]
    equal["grad_norm"] = dap["grad_norm"] == local["grad_norm"]
    for part in ("params", "opt_state"):
        equal[part] = (_digest(torch, getattr(dap["state"], part))
                       == _digest(torch, getattr(local["state"], part)))
    exp = {"fold": expected_launches(FULL, FULL.n_recycle + 1),
           "step": expected_train_launches(FULL)}
    row = {"phase": "dap nccl1", "backend": "nccl", "world_size": 1,
           "n_res": 256, "n_seq": 128, "n_blocks": FULL.evoformer.n_blocks,
           "n_recycle": FULL.n_recycle, "dtype": "bfloat16",
           "seconds": time.perf_counter() - t0,
           "equal_to_the_bit": equal, "loss": dap["loss"],
           "grad_norm": dap["grad_norm"]}
    for what in ("fold", "step"):
        row[what] = {"dap": dap[what], "local": {
            k: local[what][k] for k in ("seconds", "peak_memory_bytes")}}
    emit(row)
    if not all(equal.values()):
        fail(f"dap nccl1: not equal to the LocalDist run to the bit: {equal}")
    for what in ("fold", "step"):
        if dap[what]["launches"] != exp[what]:
            fail(f"dap nccl1 {what}: launches {dap[what]['launches']} != "
                 f"expected {exp[what]}")
    return {f"dap nccl1 {w}": dap[w]["launches"] for w in ("fold", "step")}


def _dap_inputs_path(torch, tree, tmp: str) -> str:
    import pickle

    path = os.path.join(tmp, "tree.pkl")
    with open(path, "wb") as f:
        pickle.dump(tree, f, protocol=5)
    return path


def _rank_setup(torch, rank, world, init_file, tree_path):
    """A spawned rank: the repository's ``src`` importable, a gloo group on
    the card (two ranks share it: NCCL refuses two ranks on one device),
    and the weight tree."""
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import dist as D

    D.form_group(rank, world, init_file, backend="gloo", device="cuda",
                 timeout_s=DAP_TIMEOUT_S)
    with open(tree_path, "rb") as f:
        return pickle.load(f)


def _two_rank(rank, world, init_file, tree_path, batch, tbatch):
    """One rank of the two-rank phases. DAP: the shard shapes' kernel calls
    (one block, recorded), the fold and step under DAP at DAP2_BLOCKS, and
    the fp32 point against this card's LocalDist run. Then TP on the same
    group (``_tp_work``)."""
    import torch

    tree = _rank_setup(torch, rank, world, init_file, tree_path)
    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.exec import FastFold
    from repro_torch.layers.params import tree_leaves, tree_map
    from repro_torch.train import make_train_step
    from repro_torch.weights import params_from_numpy

    out = {"rank": rank, "device": str(torch.cuda.current_device())}
    seen, where = {}, [f"dap{world} r256_s128"]
    one = params_from_numpy(dict(tree, evoformer=_slice_tree(
        tree["evoformer"], 1)), device="cuda")
    with recording_calls(seen, where):
        ff1 = FastFold(_cut(FULL, 1), plan=_gspmd_plan())
        ff1.forward(one, batch)
        where[0] = f"dap{world} train r256_s128"
        init, step = make_train_step(ff1.loss_fn)
        step(init(one), tbatch,
             torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
    del one, ff1
    out["seen"] = seen

    params = params_from_numpy(dict(tree, evoformer=_slice_tree(
        tree["evoformer"], DAP2_BLOCKS)), device="cuda")
    rec = _fold_and_step(torch, FastFold(_depth(FULL, DAP2_BLOCKS),
                                         plan=_gspmd_plan()),
                         params, batch, tbatch)
    out["fold"], out["step"] = rec["fold"], rec["step"]
    out["loss"], out["grad_norm"] = rec["loss"], rec["grad_norm"]
    out["digest"] = {part: _digest(torch, getattr(rec["state"], part))
                     for part in ("params", "opt_state")}
    if rank == 0:
        out["out"] = {k: v.float().cpu() for k, v in rec["out"].items()}
    del rec, params

    # The fp32 point: FULL widths, two blocks, recycling, no dropout.
    cut = _depth(FULL, DAP_FP32_BLOCKS)
    p32 = params_from_numpy(dict(tree, evoformer=_slice_tree(
        tree["evoformer"], DAP_FP32_BLOCKS)), device="cuda")
    res = {}
    for name, plan in (("dap", _gspmd_plan()), ("local", plan_of("default"))):
        ff = FastFold(cut, dtype=torch.float32, plan=plan)
        fold = ff.forward(p32, batch)
        live = tree_map(lambda t: t.detach().requires_grad_(True), p32)
        loss, _ = ff.loss_fn(live, tbatch)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True)
        res[name] = ({k: fold[k].float() for k in FOLD_KEYS},
                     float(loss.detach()),
                     [torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, tree_leaves(live))])
    (fd, ld, gd), (fl, ll, gl) = res["dap"], res["local"]
    out["fp32"] = {
        "fold_rel_err": {k: rel_err(fd[k], fl[k])[1] for k in FOLD_KEYS},
        "loss": [ld, ll],
        "grad_worst_rel_err": max(rel_err(a, b)[1] for a, b in zip(gd, gl)),
        "n_grads": len(gl)}
    del p32, res, gd, gl, fold, live, grads, loss, ff
    out["tp"] = _tp_work(torch, tree, rank, world)
    D.reset_collectives()
    return out


def dap2_phase(torch, tree, batch):
    """Two ranks, one process each, sharing the one card through a gloo
    group (NCCL refuses two ranks on one device), run the whole model under
    DAP: the fold (DAP2_BLOCKS blocks at FULL widths, n_recycle = 3,
    r = 256, s = 128, bf16, default plan) and one training step, held
    against the single-process port at the same depth (run here first),
    and the fp32 point; then the TP stack (``tp2_phase`` checks it). Each
    rank's launches, peak memory and bytes sent per collective kind beside
    the one-process run's. Its times are what the phase took, not DAP's
    speed: two ranks time-share one card through host memory. Returns the
    kernel calls at the shard shapes, the launches and the ranks'
    results."""
    import tempfile

    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.core.dap import block_collective_bytes
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_from_numpy

    t0 = time.perf_counter()
    cfg = _depth(FULL, DAP2_BLOCKS)
    tbatch = train_batches(1)[0]
    local = _fold_and_step(torch, FastFold(cfg, plan=plan_of("default")),
                           params_from_numpy(dict(tree, evoformer=_slice_tree(
                               tree["evoformer"], DAP2_BLOCKS)),
                               device="cuda"), batch, tbatch)
    del local["state"]
    local["out"] = {k: v.float().cpu() for k, v in local["out"].items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = _dap_inputs_path(torch, tree, tmp)
        try:
            ranks = D.run_ranks(_two_rank, DAP_RANKS, path, batch, tbatch,
                                timeout_s=DAP_TIMEOUT_S)
        except RuntimeError as e:
            fail(f"dap {DAP_RANKS}: {e}")
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    fold_err = {k: rel_err(r0["out"][k], local["out"][k])[1]
                for k in FOLD_KEYS}
    fold_equal = {k: bool(torch.equal(r0["out"][k], local["out"][k]))
                  for k in FOLD_KEYS}
    step_rel = {k: abs(r0[k] - local[k]) / max(abs(local[k]), 1e-30)
                for k in ("loss", "grad_norm")}
    same = {part: len({r["digest"][part] for r in ranks}) == 1
            for part in ("params", "opt_state")}
    same["loss"] = len({r["loss"] for r in ranks}) == 1
    model = block_collective_bytes(FULL.evoformer, batch=1, n_seq=128,
                                   n_res=256, n=DAP_RANKS)
    passes = cfg.n_recycle + 1
    per_block = {k: {"calls": r0["fold"]["collectives"][k]["forward"]["calls"]
                     / (passes * DAP2_BLOCKS),
                     "bytes": r0["fold"]["collectives"][k]["forward"]["bytes"]
                     / (passes * DAP2_BLOCKS)}
                 for k in model}
    exp = {"fold": expected_launches(cfg, passes),
           "step": expected_train_launches(cfg)}
    row = {"phase": f"dap {DAP_RANKS}", "backend": "gloo on one card",
           "world_size": DAP_RANKS, "n_res": 256, "n_seq": 128,
           "n_blocks": DAP2_BLOCKS, "n_recycle": cfg.n_recycle,
           "dtype": "bfloat16", "seconds": seconds,
           "fold_rel_err_vs_single_process": fold_err, "tol": DAP_FOLD_TOL,
           "fold_equal_to_the_bit": fold_equal,
           "step_rel_err_vs_single_process": step_rel,
           "step_rtol": DAP_STEP_RTOL, "ranks_equal": same,
           "loss": r0["loss"], "grad_norm": r0["grad_norm"],
           "fold_collectives_per_block_forward": per_block,
           "model_per_block_forward": model,
           "fp32": [r["fp32"] for r in ranks], "fp32_tol": E2E_TOL,
           "single_process": {w: {k: local[w][k] for k in
                                  ("seconds", "peak_memory_bytes")}
                              for w in ("fold", "step")},
           "ranks": [{w: r[w] for w in ("rank", "fold", "step")}
                     for r in ranks]}
    emit(row)
    checks = {
        "fold": max(fold_err.values()) <= DAP_FOLD_TOL,
        "step": max(step_rel.values()) <= DAP_STEP_RTOL,
        "ranks equal": all(same.values()),
        "collectives as modelled": per_block == model,
        "fp32": all(max(r["fp32"]["fold_rel_err"].values()) <= E2E_TOL
                    and r["fp32"]["grad_worst_rel_err"] <= GRAD_TOL
                    for r in ranks)}
    for r in ranks:
        for w in ("fold", "step"):
            checks[f"rank {r['rank']} {w} launches"] = (
                r[w]["launches"] == exp[w])
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"dap {DAP_RANKS}: {bad}")
    launches = {f"dap {DAP_RANKS} {w}": ranks[0][w]["launches"]
                for w in ("fold", "step")}
    return r0["seen"], launches, ranks


def _tp_inputs(torch, dtype):
    """The TP phase's whole inputs, from a seed: msa (1, 128, 256, 256),
    pair (1, 256, 256, 128), an MSA mask dropping ~10%, the last 20
    residues padding."""
    from repro_torch.configs import FULL

    evo = FULL.evoformer
    b, s, r = 1, 128, 256
    gen = torch.Generator().manual_seed(SEED + 9)
    msa = torch.randn((b, s, r, evo.d_msa), generator=gen).to(dtype)
    pair = torch.randn((b, r, r, evo.d_pair), generator=gen).to(dtype)
    msa_mask = (torch.rand((b, s, r), generator=gen) < 0.9).float()
    seq_mask = torch.ones((b, r))
    seq_mask[:, -20:] = 0.0
    pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
    return (msa, pair, msa_mask, seq_mask, pair_mask)


def _tp_work(torch, tree, rank, world):
    """A rank's TP work: the Evoformer stack's forward under TP on the
    rank's gloo group at TP_BLOCKS blocks, in bf16 (its kernel calls
    recorded on one block first) and in fp32."""
    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.core.tp import tp_evoformer_stack
    from repro_torch.exec.plan import use_plan
    from repro_torch.kernels import _build
    from repro_torch.weights import params_from_numpy

    params = params_from_numpy({"evoformer": _slice_tree(
        tree["evoformer"], TP_BLOCKS)}, device="cuda")["evoformer"]
    xs = [t.to("cuda") for t in _tp_inputs(torch, torch.bfloat16)]
    fn = tp_evoformer_stack(None, dataclasses.replace(
        FULL.evoformer, n_blocks=TP_BLOCKS), remat=False)
    seen, where = {}, [f"tp{world} r256_s128"]
    with use_plan(plan_of("default")), torch.inference_mode():
        with recording_calls(seen, where):
            fn(params[:1], *xs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        D.reset_collectives()
        t0 = time.perf_counter()
        msa, pair = fn(params, *xs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = {"rank": rank, "seconds": secs, "seen": seen,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": {k: _build.LAUNCHES[k] for k in TOL},
               "collectives": D.collectives()}
        f32 = params_from_numpy({"evoformer": _slice_tree(
            tree["evoformer"], TP_BLOCKS)}, device="cuda")["evoformer"]
        x32 = [t.to("cuda") for t in _tp_inputs(torch, torch.float32)]
        m32, z32 = fn(f32, *x32)
    if rank == 0:
        out["msa"], out["pair"] = msa.float().cpu(), pair.float().cpu()
        out["fp32"] = (m32.cpu(), z32.cpu())
    return out


def tp2_phase(torch, tree, ranks):
    """The two gloo ranks of ``dap2_phase`` ran the Evoformer stack's
    forward (FULL widths, TP_BLOCKS blocks, r = 256, s = 128, default plan)
    under TP, with K1, K2, K4 (H/2 heads), K7 and K8 on its path and 6
    all-reduces a block. TP materialises its attention scores, so it is
    held against the local stack under attention-oracle (the same
    attention): bf16 within DAP_FOLD_TOL, fp32 within E2E_TOL."""
    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.core.evoformer import evoformer_stack
    from repro_torch.exec.plan import use_plan
    from repro_torch.weights import params_from_numpy

    evo = dataclasses.replace(FULL.evoformer, n_blocks=TP_BLOCKS)
    ranks = [r["tp"] for r in ranks]
    want = {}
    with torch.inference_mode(), use_plan(plan_of("attention-oracle")):
        for dtype in (torch.bfloat16, torch.float32):
            params = params_from_numpy({"evoformer": _slice_tree(
                tree["evoformer"], TP_BLOCKS)}, device="cuda")["evoformer"]
            m, z = evoformer_stack(
                params, *(t.to("cuda") for t in _tp_inputs(torch, dtype)),
                cfg=evo, dist=D.LocalDist())
            want[dtype] = (m.float().cpu(), z.float().cpu())
    r0 = ranks[0]
    err = {k: rel_err(r0[k], want[torch.bfloat16][i])[1]
           for i, k in enumerate(("msa", "pair"))}
    err32 = {k: rel_err(r0["fp32"][i], want[torch.float32][i])[1]
             for i, k in enumerate(("msa", "pair"))}
    ar = r0["collectives"]["all_reduce"]["forward"]["calls"]
    row = {"phase": f"tp {DAP_RANKS}", "world_size": DAP_RANKS,
           "n_res": 256, "n_seq": 128, "n_blocks": TP_BLOCKS,
           "dtype": "bfloat16",
           "rel_err_vs_local_stack": err, "tol": DAP_FOLD_TOL,
           "fp32_rel_err": err32, "fp32_tol": E2E_TOL,
           "all_reduces_per_block_forward": ar / TP_BLOCKS,
           "ranks": [{k: rr[k] for k in ("rank", "seconds",
                                         "peak_memory_bytes", "launches",
                                         "collectives")} for rr in ranks]}
    emit(row)
    on_path = ("layer_norm", "bias_sigmoid_mul", "fused_softmax",
               "triangle_mult", "outer_product_mean")
    if (max(err.values()) > DAP_FOLD_TOL
            or max(err32.values()) > E2E_TOL or ar != 6 * TP_BLOCKS
            or any(rr["launches"][k] == 0 for rr in ranks for k in on_path)):
        fail(f"tp {DAP_RANKS}: {err} (tol {DAP_FOLD_TOL}), fp32 {err32}, "
             f"{ar} all-reduces, launches {r0['launches']}")
    return r0["seen"], {f"tp {DAP_RANKS}": r0["launches"]}


# ---------------------------------------------------------------------------
# The LM serving engine: the decoder family at full width
# ---------------------------------------------------------------------------

LM_ARCHS = ("musicgen-medium", "qwen2-1.5b")
LM_SLOTS, LM_MAX_SEQ, LM_NEW = 4, 512, 32
# Eight prompts, more than the slots, of four lengths in 32-256; the
# fourth runs under the oracle plan as a canary beside the others.
LM_PROMPT_LENS = (256, 32, 128, 64, 256, 32, 128, 64)
LM_CANARY = 3
# The bf16 plan gap (default plan, K1, against oracle) is gated on the
# model cut to LM_BF16_LAYERS layers at full width, under the per-module
# bf16 rule; the whole model's reading is printed beside the oracle's own
# bf16-vs-fp32 gap (ROADMAP.md C4).
LM_BF16_TOL = 2e-2
LM_BF16_LAYERS = 2
LM_FP32_TOL = 1e-3
LM_FP32_LAYERS = 4
# The MoE, MLA, hymba and xLSTM kinds at full width: (arch, the stages run
# where one card or the phase's time cuts the depth, max_seq). hymba's
# sliding window is 1024 tokens, and max_seq must reach it (ROADMAP.md R7).
LM_FAMILIES = (
    ("xlstm-125m", None, LM_MAX_SEQ),
    ("hymba-1.5b", None, 1024),
    ("deepseek-moe-16b", (("attn+dense", 1), ("attn+moe", 3)), LM_MAX_SEQ),
    ("deepseek-v2-236b", (("mla+dense", 1), ("mla+moe", 1)), LM_MAX_SEQ),
)
LM_FAMILY_PREFILL, LM_FAMILY_STEPS, LM_FAMILY_CPU_PROMPT = 128, 4, 32
# Decoder training at full width and depth: 3 steps of 4 x 512 tokens (512
# a multiple of mLSTM's 256-token chunk, R8), then the points on a 2-layer
# cut at 1 x 128 tokens.
LM_TRAIN_ARCHS = ("qwen2-1.5b", "musicgen-medium", "xlstm-125m")
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 512, 3
LM_TRAIN_CUT, LM_TRAIN_POINT_SEQ = 2, 128


def lm_prompts(cfg) -> list:
    """The phase's prompts, drawn by ``lm_batches`` (Zipf tokens), one
    seed each."""
    from repro_torch.data import lm_batches

    return [next(lm_batches(vocab=cfg.vocab, batch=1, seq=n,
                            seed=SEED + 20 + i)).tokens[0]
            for i, n in enumerate(LM_PROMPT_LENS)]


def lm_params(torch, cfg, seed: int, dtype=None):
    """Full-width weights drawn on the card, every leaf random
    (``random_params_like`` over the init's tree built on the meta
    device), fp32 as the reference keeps them: the model casts each
    weight where the reference does."""
    from repro_torch.models.decoder import init_model
    from repro_torch.weights import random_params_like

    with torch.device("meta"):
        skeleton = init_model(torch.Generator(), cfg)
    return random_params_like(skeleton, seed, device="cuda",
                              dtype=dtype or torch.float32)


def lm_survey(torch, seen: dict) -> None:
    """musicgen-medium's LayerNorm calls (K1) at the lm serve and lm train
    phases' shapes, recorded into ``seen`` for the kernel phase: the
    prefill of each prompt length (1, S, 1536) and the batched decode
    (4, 1, 1536) in bf16, the fp32 points' (1, 128, 1536), and a training
    batch (4, 512, 1536) in bf16 (its forward and recompute), on the model
    cut to one layer (every layer hands K1 the same shapes)."""
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import init_cache, model_forward

    cfg = dataclasses.replace(get_config("musicgen-medium"), n_layers=1)
    params = lm_params(torch, cfg, SEED + 30)
    where = [None]
    with recording_calls(seen, where), torch.no_grad():
        for n in sorted(set(LM_PROMPT_LENS)):
            where[0] = f"lm musicgen-medium prefill S={n}"
            model_forward(params, torch.zeros((1, n), dtype=torch.long,
                                              device="cuda"), cfg,
                          mode="prefill", max_cache_len=LM_MAX_SEQ)
        where[0] = f"lm musicgen-medium decode B={LM_SLOTS}"
        model_forward(params, torch.zeros((LM_SLOTS, 1), dtype=torch.long,
                                          device="cuda"), cfg, mode="decode",
                      cache=init_cache(cfg, LM_SLOTS, LM_MAX_SEQ,
                                       device="cuda"),
                      lengths=torch.full((LM_SLOTS,), 40, device="cuda"))
        where[0] = "lm musicgen-medium fp32 prefill S=128"
        model_forward(params, torch.zeros((1, 128), dtype=torch.long,
                                          device="cuda"), cfg,
                      mode="prefill", compute_dtype=torch.float32)
        where[0] = (f"lm musicgen-medium train B={LM_TRAIN_BATCH} "
                    f"S={LM_TRAIN_SEQ}")
        model_forward(params, torch.zeros((LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                                          dtype=torch.long, device="cuda"),
                      cfg)
    torch.cuda.synchronize()
    del params


@contextlib.contextmanager
def lm_calls(torch, record: list):
    """Within the scope, each prefill and decode call the serving engine
    makes appends (kind, plan name, tokens in, K1 launches, seconds) to
    ``record``, timed with a synchronise on each side."""
    from repro_torch.kernels import _build
    from repro_torch.serving import engine as eng

    orig = (eng._prefill_step, eng._decode_step)

    def name(plan):
        return "oracle" if plan == plan_of("oracle") else "default"

    def timed(kind, fn, plan, n_tokens, *args, **kw):
        torch.cuda.synchronize()
        n0 = _build.LAUNCHES["layer_norm"]
        t0 = time.perf_counter()
        out = fn(*args, plan=plan, **kw)
        torch.cuda.synchronize()
        record.append((kind, name(plan), n_tokens,
                       _build.LAUNCHES["layer_norm"] - n0,
                       time.perf_counter() - t0))
        return out

    def prefill(params, prompt, *, plan, **kw):
        return timed("prefill", orig[0], plan, prompt.shape[1], params,
                     prompt, **kw)

    def decode(params, toks, cache, lengths, *, plan, **kw):
        return timed("decode", orig[1], plan, toks.shape[0], params, toks,
                     cache, lengths, **kw)

    eng._prefill_step, eng._decode_step = prefill, decode
    try:
        yield record
    finally:
        eng._prefill_step, eng._decode_step = orig


def _greedy(torch, params, cfg, prompt, n: int, plan: str) -> list:
    """Sequential greedy decoding, one ``model_forward`` (train mode, bf16)
    over the whole sequence a token."""
    from repro_torch.exec.plan import use_plan
    from repro_torch.models.decoder import model_forward

    toks = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    out = []
    with use_plan(plan_of(plan)), torch.no_grad():
        for _ in range(n):
            logits = model_forward(params, toks, cfg)["logits"]
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            toks = torch.cat([toks, toks.new_tensor([[nxt]])], dim=1)
    return out


def _shared_lead(a: list, b: list) -> int:
    """Leading tokens two greedy runs share."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _lm_engine_run(torch, params, cfg, max_seq: int, prompts: list):
    """One ``ServingEngine`` serving the phase's requests (the canary under
    the oracle plan), every prefill and decode call timed. Returns
    (engine, requests, call record, launches, peak bytes, seconds)."""
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(params, cfg, n_slots=LM_SLOTS, max_seq=max_seq,
                           plan=plan_of("default"))
    record = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                     # the main path starts here
    t1 = time.perf_counter()
    with lm_calls(torch, record):
        reqs = [engine.submit(p, max_new_tokens=LM_NEW,
                              plan=plan_of("oracle") if i == LM_CANARY
                              else None) for i, p in enumerate(prompts)]
        engine.run()
    torch.cuda.synchronize()
    return (engine, reqs, record, dict(_build.LAUNCHES),
            torch.cuda.max_memory_allocated(), time.perf_counter() - t1)


def _lm_warm(params, cfg, max_seq: int, prompt) -> None:
    """An uncounted request (cuBLAS handles, the caching allocator)."""
    from repro_torch.serving.engine import ServingEngine

    warm = ServingEngine(params, cfg, n_slots=LM_SLOTS, max_seq=max_seq,
                         plan=plan_of("default"))
    warm.submit(prompt, max_new_tokens=2)
    warm.run()


def _lm_stats(cfg, engine, reqs, record, max_seq: int, peak: int) -> dict:
    """The printed numbers of one engine run: seconds per prefill by
    prompt length, decode seconds, tokens and tokens/s, the median decode
    step, peak memory beside the weights and the planner's model, and the
    block plan."""
    from repro_torch.memory.autochunk import decoder_attention_bytes

    prefills = [c for c in record if c[0] == "prefill"]
    decodes = [c for c in record if c[0] == "decode"]
    decode_s = sum(c[4] for c in decodes)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    model_bytes = decoder_attention_bytes(
        engine.cfg, n_slots=LM_SLOTS, max_seq=max_seq,
        q_block=engine.cfg.attn_q_block, kv_block=engine.cfg.attn_kv_block)
    return {
        "n_slots": LM_SLOTS, "max_seq": max_seq,
        "prompt_lens": list(LM_PROMPT_LENS), "new_tokens": LM_NEW,
        "canary": LM_CANARY, "statuses": [r.status for r in reqs],
        "engine_steps": engine._step_count,
        "prefill_s": {str(n): statistics.median(
            c[4] for c in prefills if c[2] == n and c[1] == "default")
            for n in sorted(set(LM_PROMPT_LENS))},
        "decode_calls": len(decodes), "decode_s": decode_s,
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "decode_step_ms_median": 1e3 * statistics.median(
            c[4] for c in decodes),
        "peak_memory_bytes": peak, "param_bytes": engine._param_bytes,
        "modelled_bytes": model_bytes,
        "modelled_plus_weights_bytes": model_bytes + engine._param_bytes,
        "block_plan": dataclasses.asdict(engine.block_plan)}


def _requests_ok(cfg, reqs) -> bool:
    """Every request done (a slot quarantined as non-finite fails), with
    LM_NEW tokens in [0, vocab)."""
    return all(r.status == "done" and len(r.generated) == LM_NEW
               and all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs)


def _cut_layers(params, cfg, n_layers: int):
    """The first ``n_layers`` layers of a one-stage model, sharing the
    weights."""
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    return {**params, "stages": [params["stages"][0][:n_layers]]}, cut


def _prefill_logits(torch, params, cfg, prompt, plan: str,
                    dtype=None) -> "torch.Tensor":
    from repro_torch.exec.plan import use_plan
    from repro_torch.models.decoder import model_forward

    with use_plan(plan_of(plan)), torch.no_grad():
        return model_forward(params, prompt, cfg, mode="prefill",
                             compute_dtype=dtype or torch.bfloat16)["logits"]


def lm_bf16_gate(torch, params, cfg, prompt) -> dict:
    """The bf16 plan gap, default plan (K1) against oracle: gated on the
    model cut to LM_BF16_LAYERS layers (full width, the same weights) at
    2e-2·max(1, max|oracle|); the cut's control, the plain LayerNorm with
    its ``beta`` left out in the first layer's first norm, must exceed the
    limit. The whole model's gap and the oracle's own bf16-vs-fp32 gap are
    printed, not gated (ROADMAP.md C4)."""
    cut_params, cut = _cut_layers(params, cfg, LM_BF16_LAYERS)
    logits = {n: _prefill_logits(torch, cut_params, cut, prompt, n)
              for n in ("default", "oracle")}
    layer0 = dict(cut_params["stages"][0][0])
    layer0["ln1"] = {**layer0["ln1"],
                     "beta": torch.zeros_like(layer0["ln1"]["beta"])}
    no_beta = {**cut_params, "stages": [[layer0]
                                        + cut_params["stages"][0][1:]]}
    control = _prefill_logits(torch, no_beta, cut, prompt, "oracle")
    whole = {n: _prefill_logits(torch, params, cfg, prompt, n)
             for n in ("default", "oracle")}
    whole_f32 = _prefill_logits(torch, params, cfg, prompt, "oracle",
                                torch.float32)
    return {
        "layers": LM_BF16_LAYERS,
        "default_vs_oracle": rel_err(logits["default"], logits["oracle"])[1],
        "control_no_beta_vs_oracle": rel_err(control, logits["oracle"])[1],
        "tol": LM_BF16_TOL,
        "whole_model_default_vs_oracle": rel_err(whole["default"],
                                                 whole["oracle"])[1],
        "whole_model_oracle_bf16_vs_fp32": rel_err(whole["oracle"],
                                                   whole_f32)[1]}


def lm_serve_one(torch, arch: str, k: int) -> tuple[dict, list]:
    """``ServingEngine`` serving ``arch`` at full width: the phase's eight
    requests (the canary under the oracle plan), after an uncounted
    warm-up request; then the bf16 plan gate (``lm_bf16_gate``). Returns
    the main path's launch counts and the engine's record of its calls."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    params = lm_params(torch, cfg, SEED + 40 + k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg)
    layer_norms = 2 * cfg.n_layers + 1 if cfg.norm == "layernorm" else 0
    _lm_warm(params, cfg, LM_MAX_SEQ, prompts[1])
    engine, reqs, record, launches, peak, run_s = _lm_engine_run(
        torch, params, cfg, LM_MAX_SEQ, prompts)
    ok_reqs = _requests_ok(cfg, reqs)
    want = {"default": layer_norms, "oracle": 0}
    bad_calls = [c for c in record if c[3] != want[c[1]]]
    others = {n: v for n, v in launches.items() if n != "layer_norm" and v}

    # Greedy agreement (printed, not gated): the first default request
    # against sequential model_forward, the canary against a default-plan
    # sequential run of its prompt.
    agree = {
        "request0_vs_sequential": _shared_lead(reqs[0].generated, _greedy(
            torch, params, cfg, prompts[0], LM_NEW, "default")),
        "canary_vs_default_plan": _shared_lead(reqs[LM_CANARY].generated, _greedy(
            torch, params, cfg, prompts[LM_CANARY], LM_NEW, "default"))}
    prompt = torch.as_tensor(prompts[0], dtype=torch.long, device="cuda")[None]
    gate = lm_bf16_gate(torch, params, cfg, prompt) if layer_norms else None
    row = {"phase": "lm serve", "arch": arch, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "norm": cfg.norm, "vocab": cfg.vocab,
           "weights": f"random on the card, seed {SEED + 40 + k}, fp32, "
                      "bf16 compute", "init_s": init_s,
           "requests_ok": ok_reqs, "run_s": run_s,
           **_lm_stats(cfg, engine, reqs, record, LM_MAX_SEQ, peak),
           "k1_launches_per_call": {
               f"{kind} {p}": sorted({c[3] for c in record
                                      if c[0] == kind and c[1] == p})
               for kind in ("prefill", "decode") for p in ("default",
                                                           "oracle")},
           "k1_expected": want, "k1_launches": launches.get("layer_norm", 0),
           "other_kernel_launches": others,
           "greedy_agreement": agree, "bf16_plan_gate": gate}
    emit(row)
    if not ok_reqs:
        fail(f"lm serve {arch}: a request did not end done with {LM_NEW} "
             f"tokens in [0, vocab): {[(r.status, r.error) for r in reqs]}")
    if bad_calls or others:
        fail(f"lm serve {arch}: K1 launches per call {bad_calls} != {want}, "
             f"or another kernel launched: {others}")
    if layer_norms and not launches.get("layer_norm"):
        fail(f"lm serve {arch}: K1 never launched")
    if gate and not (gate["default_vs_oracle"] <= LM_BF16_TOL
                     < gate["control_no_beta_vs_oracle"]):
        fail(f"lm serve {arch}: the {LM_BF16_LAYERS}-layer bf16 plan gap "
             f"{gate['default_vs_oracle']:.3g} or its control "
             f"{gate['control_no_beta_vs_oracle']:.3g} against "
             f"{LM_BF16_TOL}")
    del engine, params
    torch.cuda.empty_cache()
    return {n: launches.get(n, 0) for n in TOL}, record


def _one_layer_of_each_kind(params, cfg):
    """The model cut to the first layer of each of its kinds, in the
    order the kinds first appear, sharing the weights."""
    kinds, stages = [], []
    for i, (kind, _) in enumerate(cfg.resolved_stages):
        if kind not in kinds:
            kinds.append(kind)
            stages.append([params["stages"][i][0]])
    cut = dataclasses.replace(cfg, stages=tuple((k, 1) for k in kinds),
                              n_layers=len(kinds))
    return {**params, "stages": stages}, cut


@contextlib.contextmanager
def _router_margins(margins: list):
    """Within the scope, each MoE router call appends its smallest top-k
    margin (the k-th largest probability less the next) to ``margins``."""
    from repro_torch.models import moe

    orig = moe.route

    def route(p, xf, cfg):
        out = orig(p, xf, cfg)
        top = out[0].topk(cfg.top_k + 1, dim=-1).values
        margins.append((top[:, -2] - top[:, -1]).min().item())
        return out

    moe.route = route
    try:
        yield margins
    finally:
        moe.route = orig


def _prefill_and_decode(torch, params, cfg, prompt, steps: int, toks=None):
    """fp32 logits of the prompt's last position and of ``steps`` decode
    steps from the prefill's cache: (B, steps + 1, vocab), and the tokens
    fed (the greedy tokens of the logits where ``toks`` is None)."""
    from repro_torch.models.decoder import model_forward

    s = prompt.shape[1]
    f32 = dict(compute_dtype=torch.float32)
    with torch.no_grad():
        out = model_forward(params, prompt, cfg, mode="prefill",
                            max_cache_len=s + steps, **f32)
        logits, cache = [out["logits"][:, -1]], out["cache"]
        toks = list(toks) if toks is not None else []
        for i in range(steps):
            if len(toks) <= i:
                toks.append(int(torch.argmax(logits[-1][0])))
            out = model_forward(params, prompt.new_tensor([[toks[i]]]), cfg,
                                mode="decode", cache=cache,
                                lengths=prompt.new_tensor([s + i]), **f32)
            cache = out["cache"]
            logits.append(out["logits"][:, -1])
    return torch.stack(logits, dim=1), toks


def lm_family_fp32(torch, arch: str, params, cfg) -> dict:
    """Two fp32 points on ``arch`` cut to one layer of each kind at full
    width: (a) a LM_FAMILY_PREFILL-token prefill and LM_FAMILY_STEPS decode
    steps against a recompute of the whole sequence, MoE capacity raised
    to the tokens of each call; (b) a LM_FAMILY_CPU_PROMPT-token prefill
    and 2 decode steps at the default capacity, the card against the port
    on the host's CPU. Both at LM_FP32_TOL."""
    from repro_torch.layers.params import tree_map
    from repro_torch.models.decoder import model_forward

    cut_params, cut = _one_layer_of_each_kind(params, cfg)
    prompts = lm_prompts(cut)
    row = {"kinds": [k for k, _ in cut.resolved_stages], "tol": LM_FP32_TOL}
    # (a) Capacity couples the tokens of a call: only at capacity = n is a
    # decode step the recompute's routing. capacity_factor = E makes the
    # capacity E·n·k/E >= n for every call.
    full_cap = cut
    if cut.moe:
        full_cap = dataclasses.replace(cut, moe=dataclasses.replace(
            cut.moe, capacity_factor=float(cut.moe.n_experts)))
        row["recompute_capacity_factor"] = full_cap.moe.capacity_factor
        row["recompute_capacity_note"] = (
            "raised from the default so that capacity equals the tokens of "
            "every call: no token is dropped, and a decode step routes as "
            "the recompute does")
    prompt = torch.as_tensor(
        next(iter(p for p in prompts if len(p) == LM_FAMILY_PREFILL)),
        dtype=torch.long, device="cuda")[None]
    s = prompt.shape[1]
    steps, toks = _prefill_and_decode(torch, cut_params, full_cap, prompt,
                                      LM_FAMILY_STEPS)
    with torch.no_grad():
        full = model_forward(cut_params, torch.cat(
            [prompt, prompt.new_tensor([toks])], dim=1), full_cap,
            compute_dtype=torch.float32)["logits"][:, s - 1:]
    row["prefill_len"], row["decode_steps"] = s, LM_FAMILY_STEPS
    row["cache_vs_recompute"] = rel_err(steps, full)[1]
    # (b) The card against the host, the same weights, default capacity.
    prompt = torch.as_tensor(
        next(iter(p for p in prompts if len(p) == LM_FAMILY_CPU_PROMPT)),
        dtype=torch.long, device="cuda")[None]
    margins = []
    with _router_margins(margins):
        card, toks = _prefill_and_decode(torch, cut_params, cut, prompt, 2)
    torch.cuda.synchronize()
    host = tree_map(lambda t: t.cpu(), cut_params)
    cpu, _ = _prefill_and_decode(torch, host, cut, prompt.cpu(), 2, toks)
    del host
    row["cpu_prompt_len"] = prompt.shape[1]
    row["card_vs_cpu"] = rel_err(card.cpu(), cpu)[1]
    row["router_min_topk_margin"] = min(margins) if margins else None
    row["ok"] = (row["cache_vs_recompute"] <= LM_FP32_TOL
                 and row["card_vs_cpu"] <= LM_FP32_TOL)
    return row


def lm_family_one(torch, arch: str, stages, max_seq: int, k: int) -> dict:
    """``arch`` (the MoE, MLA, hymba or xLSTM kinds) at full width, its
    depth cut to ``stages`` where given: the phase's eight requests after
    a warm-up, checked (all done, no kernel launched), served again to the
    same tokens, then the fp32 points (``lm_family_fp32``). Returns the
    main path's launch counts."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if stages is not None:
        cfg = dataclasses.replace(cfg, stages=stages,
                                  n_layers=sum(n for _, n in stages))
    params = lm_params(torch, cfg, SEED + 60 + k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg)
    _lm_warm(params, cfg, max_seq, prompts[1])
    engine, reqs, record, launches, peak, run_s = _lm_engine_run(
        torch, params, cfg, max_seq, prompts)
    stats = _lm_stats(cfg, engine, reqs, record, max_seq, peak)
    del engine
    ok_reqs = _requests_ok(cfg, reqs)
    k1_calls = sorted({c[3] for c in record})
    others = {n: v for n, v in launches.items() if v}
    engine2, again, _, _, _, _ = _lm_engine_run(torch, params, cfg, max_seq,
                                                prompts)
    del engine2
    same = [r.generated for r in again] == [r.generated for r in reqs]
    fp32 = lm_family_fp32(torch, arch, params, cfg)
    row = {"phase": "lm serve", "arch": arch, "n_layers": cfg.n_layers,
           "stages": [list(st) for st in cfg.resolved_stages],
           "depth": "full" if stages is None else "cut",
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "vocab": cfg.vocab,
           "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
           "mla": dataclasses.asdict(cfg.mla) if cfg.mla else None,
           "ssm": dataclasses.asdict(cfg.ssm) if cfg.ssm else None,
           "weights": f"random on the card, seed {SEED + 60 + k}, fp32, "
                      "bf16 compute", "init_s": init_s,
           "requests_ok": ok_reqs, "run_s": run_s, **stats,
           "k1_launches_per_call": k1_calls,
           "other_kernel_launches": others,
           "second_run_same_tokens": same, "fp32": fp32}
    emit(row)
    if not ok_reqs:
        fail(f"lm serve {arch}: a request did not end done with {LM_NEW} "
             f"tokens in [0, vocab): {[(r.status, r.error) for r in reqs]}")
    if others or k1_calls != [0]:
        fail(f"lm serve {arch}: a kernel launched: {others}, K1 per call "
             f"{k1_calls}")
    if not same:
        fail(f"lm serve {arch}: a second engine run gave other tokens")
    if not fp32["ok"]:
        fail(f"lm serve {arch}: an fp32 point is off: {fp32}")
    del params
    torch.cuda.empty_cache()
    return {n: launches.get(n, 0) for n in TOL}


def lm_fp32_point(torch) -> None:
    """musicgen-medium at full width cut to 4 layers, fp32 (K1's loop
    path): a prefill and 4 decode steps under the default plan and the
    oracle plan, held together, and the logits from the cache against a
    recompute of the whole sequence."""
    from repro_torch.configs import get_config
    from repro_torch.exec.plan import use_plan
    from repro_torch.kernels import _build
    from repro_torch.models.decoder import model_forward

    cfg = dataclasses.replace(get_config("musicgen-medium"),
                              n_layers=LM_FP32_LAYERS)
    params = lm_params(torch, cfg, SEED + 50)
    prompt = torch.as_tensor(lm_prompts(cfg)[2], dtype=torch.long,
                             device="cuda")[None]
    s, steps = prompt.shape[1], 4
    f32 = dict(compute_dtype=torch.float32)
    # The oracle's greedy tokens, fed to both plans.
    runs, toks, k1 = {}, [], {}
    with torch.no_grad():
        for name in ("oracle", "default"):
            _build.reset_launches()
            with use_plan(plan_of(name)):
                out = model_forward(params, prompt, cfg, mode="prefill",
                                    max_cache_len=s + steps, **f32)
                logits = [out["logits"][:, -1]]
                cache = out["cache"]
                for i in range(steps):
                    if len(toks) <= i:
                        toks.append(int(torch.argmax(logits[-1][0])))
                    out = model_forward(
                        params, prompt.new_tensor([[toks[i]]]), cfg,
                        mode="decode", cache=cache,
                        lengths=prompt.new_tensor([s + i]), **f32)
                    cache = out["cache"]
                    logits.append(out["logits"][:, -1])
                if name == "default":
                    full = model_forward(params, torch.cat(
                        [prompt, prompt.new_tensor([toks])], dim=1), cfg,
                        **f32)["logits"][:, s - 1:]
            torch.cuda.synchronize()
            k1[name] = _build.LAUNCHES["layer_norm"]
            runs[name] = torch.stack(logits, dim=1)
    plans = rel_err(runs["default"], runs["oracle"])[1]
    recompute = rel_err(runs["default"], full)[1]
    per_forward = 2 * LM_FP32_LAYERS + 1
    row = {"phase": "lm fp32", "arch": "musicgen-medium",
           "n_layers": LM_FP32_LAYERS, "prompt_len": s, "decode_steps": steps,
           "default_vs_oracle": plans, "cache_vs_recompute": recompute,
           "tol": LM_FP32_TOL, "k1_launches": k1,
           "k1_expected": {"default": per_forward * (steps + 2),
                           "oracle": 0}}
    row["ok"] = (plans <= LM_FP32_TOL and recompute <= LM_FP32_TOL
                 and k1 == row["k1_expected"])
    emit(row)
    if not row["ok"]:
        fail(f"lm fp32 point: {row}")
    del params


def lm_serve_phase(torch) -> tuple[dict, dict]:
    """The ``lm serve`` phase; returns each configuration's launches and
    each LM_ARCHS model's record of its calls."""
    t0 = time.perf_counter()
    launches, records = {}, {}
    for k, arch in enumerate(LM_ARCHS):
        launches[f"lm serve {arch}"], records[arch] = lm_serve_one(
            torch, arch, k)
    lm_fp32_point(torch)
    for k, (arch, stages, max_seq) in enumerate(LM_FAMILIES):
        t1 = time.perf_counter()
        launches[f"lm serve {arch}"] = lm_family_one(torch, arch, stages,
                                                     max_seq, k)
        emit({"phase": "lm serve seconds", "arch": arch,
              "seconds": time.perf_counter() - t1})
    emit({"phase": "lm serve seconds", "seconds": time.perf_counter() - t0})
    return launches, records


def _bit_digest(torch, state, metrics) -> list:
    """The loss's and gradient norm's bits, and the sum of each parameter
    and moment leaf's 32-bit words: equal digests of two steps say their
    results are equal to the bit (up to a collision of the sums)."""
    from repro_torch.layers.params import tree_leaves

    leaves = (tree_leaves(state.params) + tree_leaves(state.opt_state.m)
              + tree_leaves(state.opt_state.v))
    sums = torch.stack([t.view(torch.int32).sum(dtype=torch.int64)
                        for t in leaves if t.numel()])
    return ([float(metrics["loss"]), float(metrics["grad_norm"])]
            + sums.tolist())


def lm_train_one(torch, arch: str, k: int) -> tuple[dict, dict]:
    """``arch`` trained at full width and depth through
    ``launch.train.train``: LM_TRAIN_STEPS steps, each checked as it ends
    (finite loss and gradient norm, no skip, K1's launches), then two
    identical steps from the last state. Returns the main path's launches
    and the median step's seconds and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.layers.params import count_params

    cfg = get_config(arch)
    per_step = 4 * cfg.n_layers + 1 if cfg.norm == "layernorm" else 0
    steps, last = [], {}

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append({
            "step": i + 1, "seconds": now - last["t"],
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "nonfinite_skips": float(metrics["nonfinite_skips"]),
            "k1_launches": _build.LAUNCHES["layer_norm"] - last["k1"]})
        last.update(t=now, k1=_build.LAUNCHES["layer_norm"],
                    n_params=count_params(state.params))

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()                     # the main path starts here
    last.update(t=time.perf_counter(), k1=0)
    state = launch_train.train(
        cfg, lm_params(torch, cfg, SEED + 70 + k), steps=LM_TRAIN_STEPS,
        batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, device="cuda",
        on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    run_s = time.perf_counter() - t0
    # Two identical steps from the last state on one batch (uncounted).
    _, step = launch_train.make_lm_step(cfg, steps=LM_TRAIN_STEPS,
                                        batch=LM_TRAIN_BATCH,
                                        seq=LM_TRAIN_SEQ)
    batch = launch_train.lm_batch(next(lm_batches(
        vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
        seed=SEED + 80)), cfg, "cuda")
    digests = []
    for _ in range(2):
        digests.append(_bit_digest(torch, *step(state, batch)))
    del state
    torch.cuda.empty_cache()
    n_params = last["n_params"]
    warm = statistics.median(r["seconds"] for r in steps[1:])
    others = {n: v for n, v in launches.items() if n != "layer_norm" and v}
    row = {"phase": "lm train", "arch": arch, "n_layers": cfg.n_layers,
           "stages": [list(st) for st in cfg.resolved_stages],
           "d_model": cfg.d_model, "vocab": cfg.vocab, "norm": cfg.norm,
           "params": n_params,
           "weights": f"random on the card, seed {SEED + 70 + k}, fp32, "
                      "bf16 compute, AdamW", "batch": LM_TRAIN_BATCH,
           "seq": LM_TRAIN_SEQ, "steps": steps,
           "step_s_median_2_3": warm,
           "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / warm,
           "run_s": run_s, "peak_memory_bytes": peak,
           "state_bytes_reckoned": 12 * n_params,
           "k1_per_step_expected": per_step,
           "k1_launches": launches.get("layer_norm", 0),
           "other_kernel_launches": others,
           "two_identical_steps_same_bits": digests[0] == digests[1],
           "two_identical_steps_loss": [d[0] for d in digests]}
    emit(row)
    bad = [r for r in steps if not (math.isfinite(r["loss"])
                                    and math.isfinite(r["grad_norm"])
                                    and r["nonfinite_skips"] == 0
                                    and r["k1_launches"] == per_step)]
    if len(steps) != LM_TRAIN_STEPS or bad:
        fail(f"lm train {arch}: steps {bad or steps} (finite loss and "
             f"gradient norm, no skip, K1 {per_step} a step)")
    if others:
        fail(f"lm train {arch}: another kernel launched: {others}")
    return ({n: launches.get(n, 0) for n in TOL},
            {"step_s": warm, "peak_memory_bytes": peak})


def _cut_for_training(params, cfg):
    """The first LM_TRAIN_CUT layers of a one-stage model, or one layer of
    each kind (xLSTM's mLSTM and sLSTM), sharing the weights."""
    if len(cfg.resolved_stages) == 1:
        return _cut_layers(params, cfg, LM_TRAIN_CUT)
    return _one_layer_of_each_kind(params, cfg)


def _lm_grads(torch, params, cfg, batch, dtype, plan: str = "default"):
    """[loss, every gradient leaf] of ``lm_loss`` at ``dtype`` compute
    under ``plan``; zero-size leaves left out."""
    from repro_torch.exec.plan import use_plan
    from repro_torch.layers.params import tree_leaves, tree_map
    from repro_torch.models.decoder import lm_loss

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with use_plan(plan_of(plan)):
        loss, _ = lm_loss(live, batch, cfg, compute_dtype=dtype)
        loss.backward()
    return [loss.detach()] + [t.grad for t in tree_leaves(live) if t.numel()]


def _grad_gap(got: list, want: list) -> float:
    """max over the loss and each gradient leaf of
    max|got - want| / max(1, max|want|)."""
    return max(rel_err(g.cpu(), w.cpu())[1] for g, w in zip(got, want))


def lm_train_points(torch, arch: str, k: int) -> dict:
    """``arch`` at full width cut to LM_TRAIN_CUT layers, one batch of
    1 x LM_TRAIN_POINT_SEQ tokens: fp32, the loss and every gradient on the
    card against the port on the host's CPU; for a LayerNorm model also
    bf16, the default plan (K1) against oracle, gated, with its control,
    and the whole model's gap, printed."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.train import lm_batch
    from repro_torch.layers.params import tree_map

    cfg = get_config(arch)
    full = lm_params(torch, cfg, SEED + 90 + k)
    params, cut = _cut_for_training(full, cfg)
    if cfg.norm != "layernorm":
        del full
    lb = next(lm_batches(vocab=cfg.vocab, batch=1, seq=LM_TRAIN_POINT_SEQ,
                         seed=SEED + 91 + k))
    card = _lm_grads(torch, params, cut, lm_batch(lb, cut, "cuda"),
                     torch.float32)
    host = _lm_grads(torch, tree_map(lambda t: t.cpu(), params), cut,
                     lm_batch(lb, cut, "cpu"), torch.float32)
    row = {"phase": "lm train point", "arch": arch,
           "kinds": [kd for kd, _ in cut.resolved_stages],
           "layers": cut.n_layers, "tokens": LM_TRAIN_POINT_SEQ,
           "fp32_card_vs_cpu": _grad_gap(card, host), "fp32_tol": LM_FP32_TOL,
           "loss_card": float(card[0]), "loss_cpu": float(host[0])}
    del card, host
    ok = row["fp32_card_vs_cpu"] <= LM_FP32_TOL
    if cut.norm == "layernorm":
        batch = lm_batch(lb, cut, "cuda")
        bf16 = {n: _lm_grads(torch, params, cut, batch, torch.bfloat16, n)
                for n in ("default", "oracle")}
        layer0 = dict(params["stages"][0][0])
        layer0["ln1"] = {**layer0["ln1"],
                         "beta": torch.zeros_like(layer0["ln1"]["beta"])}
        no_beta = {**params, "stages": [[layer0] + params["stages"][0][1:]]}
        control = _lm_grads(torch, no_beta, cut, batch, torch.bfloat16,
                            "oracle")
        row.update({
            "bf16_default_vs_oracle": _grad_gap(bf16["default"],
                                                bf16["oracle"]),
            "bf16_control_no_beta_vs_oracle": _grad_gap(control,
                                                        bf16["oracle"]),
            "bf16_tol": LM_BF16_TOL})
        del bf16, control
        # The whole model's gap, printed, not gated (ROADMAP.md C4).
        whole = {n: _lm_grads(torch, full, cfg, batch, torch.bfloat16, n)
                 for n in ("default", "oracle")}
        row["bf16_whole_model_default_vs_oracle"] = _grad_gap(
            whole["default"], whole["oracle"])
        del whole, full
        ok = ok and (row["bf16_default_vs_oracle"] <= LM_BF16_TOL
                     < row["bf16_control_no_beta_vs_oracle"])
    row["ok"] = ok
    emit(row)
    if not ok:
        fail(f"lm train point {arch}: {row}")
    del params
    torch.cuda.empty_cache()
    return row


def lm_train_cli(torch) -> dict:
    """``python -m repro_torch.launch.train`` in this process, on the card
    by default: 2 steps of xlstm-125m with ``--trace``, the trace read
    back by ``python -m repro_torch.obs report --strict``."""
    import io

    from repro_torch.launch import train as launch_train
    from repro_torch.obs.__main__ import main as obs_report
    from repro_torch.obs.events import read_jsonl

    path = ROOT / "build" / "lm_train_events.jsonl"
    path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "xlstm-125m", "--steps", "2",
                           "--trace", str(path)])
        rc = obs_report(["report", str(path), "--strict"])
    events = [e for e in read_jsonl(str(path)) if e["kind"] == "train_step"]
    row = {"phase": "lm train cli", "arch": "xlstm-125m",
           "seconds": time.perf_counter() - t0, "report_rc": rc,
           "train_step_events": len(events),
           "output": out.getvalue().splitlines()[-12:]}
    emit(row)
    if rc != 0 or len(events) != 2:
        fail(f"lm train cli: {row}")
    torch.cuda.empty_cache()
    return row


def lm_train_phase(torch) -> tuple[dict, dict]:
    """The ``lm train`` phase; returns each configuration's launches and
    what ``lm_train_one`` measured of it."""
    t0 = time.perf_counter()
    launches, measured = {}, {}
    for k, arch in enumerate(LM_TRAIN_ARCHS):
        t1 = time.perf_counter()
        launches[f"lm train {arch}"], measured[arch] = lm_train_one(
            torch, arch, k)
        lm_train_points(torch, arch, k)
        emit({"phase": "lm train seconds", "arch": arch,
              "seconds": time.perf_counter() - t1})
    lm_train_cli(torch)
    emit({"phase": "lm train seconds", "seconds": time.perf_counter() - t0})
    return launches, measured


# ---------------------------------------------------------------------------
# The analysis gate and the examples
# ---------------------------------------------------------------------------

ANALYSIS_RANKS = 2
# The contract cells' widths lie outside the flash attention, triangle and
# OPM kernels (as SMOKE's): under the default plan the Evoformer cells take
# the materialized branches, with these kernels; under oracle none.
ANALYSIS_KERNELS = ("layer_norm", "bias_sigmoid_mul", "fused_softmax")


def analysis_phase(torch) -> None:
    """``repro_torch.analysis`` on the card: repro-lint over the port's
    tree, then the contract matrix (every cell under default and oracle)
    on two gloo ranks sharing the card. One line a row: modeled bytes, the
    allocator's peak of each rank above what it held before the cell, the
    ratio, collectives per block and rank 0's kernel launches. Any finding
    or violation fails the run."""
    from repro_torch.analysis import cells, lint

    t0 = time.perf_counter()
    findings = lint.lint_tree()
    emit({"phase": "analysis lint", "report": lint.render_report(findings)})
    if findings:
        fail(f"repro-lint: {len(findings)} finding(s)")
    try:
        violations, rows = cells.run_matrix(
            ("default", "oracle"), ranks=ANALYSIS_RANKS, device="cuda",
            timeout_s=DAP_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"analysis: {e}")
    bad = [v.render() for v in violations]
    for row in rows:
        cell = row["cell"].split("/")[0]
        emit({"phase": "analysis", **{k: row[k] for k in (
            "cell", "modeled_bytes", "peak_bytes", "peak_bytes_by_rank",
            "ratio", "collectives", "launches", "violations")},
            "peak_limits": list(cells.PEAK_LIMITS[cell]),
            "collective_limits": list(cells.COLLECTIVE_BUDGETS[cell])})
        if row["preset"] == "oracle" and row["launches"]:
            bad.append(f"{row['cell']}: kernels launched under oracle")
        if (row["preset"] == "default" and cell != "triangle_opm"
                and not all(row["launches"].get(k) for k in
                            ANALYSIS_KERNELS)):
            bad.append(f"{row['cell']}: not every one of {ANALYSIS_KERNELS}"
                       f" launched: {row['launches']}")
    emit({"phase": "analysis seconds", "seconds": time.perf_counter() - t0,
          "rows": len(rows), "violations": bad})
    if bad:
        fail(f"analysis: {bad}")


def _run_example(script: str, args: list, keys: tuple) -> dict:
    """``examples/<script> args`` in its own process, as a user runs it."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    return {"phase": "examples", "script": script, "args": args,
            "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "missing": [k for k in keys if k not in proc.stdout],
            "output": proc.stdout.splitlines()[-8:],
            "stderr": proc.stderr[-2000:] if proc.returncode else ""}


def examples_phase(torch) -> None:
    """Each ``examples/torch_*.py`` once on the card at its smallest
    arguments, as a user runs it (its own process, ``PYTHONPATH=src``),
    the four side by side: the quickstart; the mini trainer for 2 steps
    with a checkpoint a step, then to step 3 resuming from the newest; the
    DAP long inference on 1, 2 and 4 ranks sharing the card; the LM server
    under its chaos schedule. Each must exit 0 and print its key lines."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    ckpt = ROOT / "build" / "example_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    train = ["--ckpt-every", "1", "--ckpt-dir", str(ckpt)]
    chains = [
        [("torch_quickstart.py", [], ("predicted CA coords", "generated:"))],
        [("torch_train_alphafold_mini.py", ["--steps", "2"] + train,
          ("device=cuda", "ckpt_00000002.npz")),
         ("torch_train_alphafold_mini.py", ["--steps", "3"] + train,
          ("resumed from", "step    3"))],
        [("torch_distributed_long_inference.py", ["--n-res", "32"],
          ("ranks=4 rank=3 n_res=32",))],
        [("torch_serve_llm.py", ["--requests", "4", "--max-new", "4",
                                 "--chaos"], ("chaos: injected",
                                              "served 4"))],
    ]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(chains)) as pool:
        done = list(pool.map(lambda chain: [_run_example(*r) for r in chain],
                             chains))
    bad = []
    for row in (r for chain in done for r in chain):
        emit(row)
        if row["rc"] != 0 or row["missing"]:
            bad.append(row["script"])
    emit({"phase": "examples seconds", "seconds": time.perf_counter() - t0})
    if bad:
        fail(f"examples: {bad}")


# ---------------------------------------------------------------------------
# The roofline of each FULL-width path
# ---------------------------------------------------------------------------

# The dry-run's one-device peak for a training step, held against the one
# the lm train phase measured: within this factor either way (the
# reference's PeakBytesWithin headroom).
PEAK_MODEL_HEADROOM = 2.0
ROOFLINE_ARCH = "qwen2-1.5b"


def _counter(torch, fn):
    """The ``roofline.analysis`` counter of one call of ``fn``."""
    from repro_torch.roofline import analysis

    torch.cuda.synchronize()
    with analysis.counting() as c:
        fn()
    torch.cuda.synchronize()
    return c


def _count(torch, fn) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one call of ``fn``, counted on the card."""
    c = _counter(torch, fn)
    return c.flops, c.hbm_bytes


def _deeper(one, two, n: int) -> tuple[float, float]:
    """Counts at depth 1 and 2, extrapolated to depth ``n`` (each further
    block or layer adds what the second added)."""
    return tuple(a + (n - 1) * (b - a) for a, b in zip(one, two))


def _roof_line(path: str, counted, measured_s: float, model_flops: float,
               **extra) -> dict:
    """One ``roofline`` line: the counted work against one H100's peaks
    (989 TFLOP/s bf16, 3.35 TB/s), the measured seconds, the share of them
    the roofline explains, and the model and executed FLOPs as shares of
    the card's bf16 peak. Fails unless 0 < share <= 1."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    flops, nbytes = counted
    t_c, t_m = flops / PEAK_FLOPS_BF16, nbytes / HBM_BW
    share = max(t_c, t_m) / measured_s
    row = {"phase": "roofline", "path": path, "flops": flops,
           "hbm_bytes": nbytes, "t_compute_s": t_c, "t_memory_s": t_m,
           "bottleneck": "compute" if t_c >= t_m else "memory",
           "measured_s": measured_s, "roofline_share": share,
           "mfu": model_flops / (measured_s * PEAK_FLOPS_BF16),
           "hfu": flops / (measured_s * PEAK_FLOPS_BF16),
           "model_flops": model_flops, **extra}
    emit(row)
    if not 0.0 < share <= 1.0:
        fail(f"roofline {path}: share {share:.3g} outside (0, 1]: a time "
             "under the roofline means the count is wrong")
    return row


def _fold_counts(torch, tree, batches, measured) -> None:
    """The served folds (r = 256 and 384, 48 blocks, n_recycle = 3) under
    the default plan and attention-oracle, counted on the card at 1 and 2
    blocks; the training step under both plans likewise, and without
    recomputation (the model FLOPs)."""
    from repro_torch.configs import FULL
    from repro_torch.core.alphafold import alphafold_train_loss
    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import use_plan
    from repro_torch.train import make_train_step
    from repro_torch.weights import params_from_numpy

    nb = FULL.evoformer.n_blocks

    def cfg_at(n):
        return dataclasses.replace(FULL, evoformer=dataclasses.replace(
            FULL.evoformer, n_blocks=n))

    params = {n: params_from_numpy(
        dict(tree, evoformer=_slice_tree(tree["evoformer"], n)),
        device="cuda") for n in (1, 2)}
    for plan in ("default", "attention-oracle"):
        for name in ("r256_s128", "r384_s128"):
            batch = batches[[r for r, _ in REQUESTS].index(name)]
            counts = [_count(torch, lambda n=n: FastFold(
                cfg_at(n), plan=plan_of(plan)).serve(params[n], [batch]))
                for n in (1, 2)]
            counted = _deeper(*counts, nb)
            _roof_line(f"fold {name} {plan}", counted,
                       measured["serve"][plan][name], counted[0],
                       n_blocks=nb, n_recycle=FULL.n_recycle,
                       counted_at_blocks=[1, 2])
    batch = train_batches(1)[0]

    def step_count(n, plan, remat=True):
        ff = FastFold(cfg_at(n), plan=plan_of(plan))
        loss_fn = ff.loss_fn
        if not remat:
            def loss_fn(p, b, rng):
                with use_plan(plan_of(plan)):
                    return alphafold_train_loss(p, ff.batch_to_device(b),
                                                ff.config, generator=rng,
                                                remat=False)
        init, step = make_train_step(loss_fn)
        state = init(ff.init(seed=SEED))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return _count(torch, lambda: step(state, batch, gen))

    model = _deeper(step_count(1, "default", False),
                    step_count(2, "default", False), nb)
    for plan in ("default", "attention-oracle"):
        counted = _deeper(step_count(1, plan), step_count(2, plan), nb)
        _roof_line(f"train r256_s128 {plan}", counted,
                   measured["train"][plan], model[0], n_blocks=nb,
                   n_recycle=FULL.n_recycle, remat=True,
                   model_flops_counted="the same step without "
                                       "recomputation, default plan",
                   counted_at_blocks=[1, 2])


def _lm_counts(torch, measured) -> None:
    """The LM serve prefill (256 tokens into 512 rows) and decode call
    (4 slots) of each LM_ARCHS model, and the LM train step (4 x 512) of
    each LM_TRAIN_ARCHS model, counted on the card at one and two layers
    of each kind (``launch.dryrun``'s depth runs) with weights drawn on
    the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import lm_batches
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.layers.params import count_params
    from repro_torch.models.decoder import init_cache, init_model
    from repro_torch.roofline import analysis
    from repro_torch.serving import engine as eng

    def n_params(cfg):
        with torch.device("meta"):
            return count_params(init_model(torch.Generator(), cfg))

    def depth_counts(cfg, setup):
        """``setup(cut)`` draws the weights (uncounted) and returns the
        call to count."""
        def measure(cut):
            return dryrun.Run(*_count(torch, setup(cut)))
        run, depths = dryrun._depth_runs(cfg, measure)
        return (run.flops, run.hbm_bytes), depths

    for k, arch in enumerate(LM_ARCHS):
        cfg = get_config(arch)
        record = measured["lm serve"][arch]
        prompt_len = max(LM_PROMPT_LENS)
        prompt = torch.as_tensor(lm_prompts(cfg)[0][:prompt_len],
                                 dtype=torch.long, device="cuda")[None]

        def prefill(cut):
            params = lm_params(torch, cut, SEED + 40 + k)
            return lambda: eng._prefill_step(
                params, prompt, cfg=cut, plan=plan_of("default"),
                max_cache_len=LM_MAX_SEQ)

        def decode(cut):
            params = lm_params(torch, cut, SEED + 40 + k)
            cache = init_cache(cut, LM_SLOTS, LM_MAX_SEQ, device="cuda")
            toks = torch.zeros((LM_SLOTS, 1), dtype=torch.long,
                               device="cuda")
            lengths = torch.full((LM_SLOTS,), LM_MAX_SEQ // 2,
                                 dtype=torch.long, device="cuda")
            return lambda: eng._decode_step(params, toks, cache, lengths,
                                            cfg=cut, plan=plan_of("default"))

        n = n_params(cfg)
        for kind, fn, tokens in (("prefill", prefill, prompt_len),
                                 ("decode", decode, LM_SLOTS)):
            times = [c[4] for c in record if c[0] == kind
                     and c[1] == "default" and c[2] == tokens]
            counted, depths = depth_counts(cfg, fn)
            shape = ShapeConfig(kind, prompt_len if kind == "prefill"
                                else LM_MAX_SEQ,
                                1 if kind == "prefill" else LM_SLOTS, kind)
            _roof_line(f"lm serve {arch} {kind}", counted,
                       statistics.median(times),
                       analysis.model_flops(shape, n), tokens=tokens,
                       calls_timed=len(times), params=n,
                       counted_at_layers=depths)
    for k, arch in enumerate(LM_TRAIN_ARCHS):
        cfg = get_config(arch)
        batch = launch_train.lm_batch(next(lm_batches(
            vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
            seed=SEED + 80)), cfg, "cuda")

        def train(cut):
            init, step = launch_train.make_lm_step(
                cut, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                seq=LM_TRAIN_SEQ)
            state = init(lm_params(torch, cut, SEED + 70 + k))
            return lambda: step(state, batch)

        n = n_params(cfg)
        counted, depths = depth_counts(cfg, train)
        shape = ShapeConfig("train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
        _roof_line(f"lm train {arch}", counted,
                   measured["lm train"][arch]["step_s"],
                   analysis.model_flops(shape, n),
                   tokens=LM_TRAIN_BATCH * LM_TRAIN_SEQ, params=n,
                   counted_at_layers=depths)


def _count_parity(torch, tree, batches) -> None:
    """The parity phase's cut (FULL widths, 2 blocks, no recycling, fp32,
    the first request, the default plan with one stated budget) counted on
    the card, where the kernels run, and on the host's CPU, where the
    plain versions run, the request's features already on each device:
    the counts must be equal."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.weights import params_from_numpy

    cfg = _cut(FULL, 2)
    cut = dict(tree, evoformer=_slice_tree(tree["evoformer"], 2))
    plan = plan_of("default").with_memory(hbm_budget=HBM_BYTES)
    counters = {}
    for dev in ("cuda", "cpu"):
        ff = FastFold(cfg, device=dev, dtype=torch.float32, plan=plan)
        params = params_from_numpy(cut, device=dev)
        batch = ff.batch_to_device(batches[0])
        counters[dev] = _counter(torch, lambda: ff.forward(params, batch))
    card, host = ((c.flops, c.hbm_bytes) for c in counters.values())
    emit({"phase": "roofline count parity", "cut": {"n_blocks": 2,
                                                     "n_recycle": 0},
          "width": "FULL", "dtype": "float32", "request": REQUESTS[0][0],
          "plan": "default", "card": {"flops": card[0], "hbm_bytes": card[1]},
          "cpu": {"flops": host[0], "hbm_bytes": host[1]},
          "equal": card == host,
          "ops_that_differ": {
              k: {dev: c.by_op.get(k) for dev, c in counters.items()}
              for k in set(counters["cuda"].by_op) | set(counters["cpu"].by_op)
              if counters["cuda"].by_op.get(k) != counters["cpu"].by_op.get(k)}})
    if card != host:
        fail(f"roofline: the card counts {card}, the CPU {host}, on the "
             "parity cut")


def _peak_prediction(torch, measured) -> None:
    """``launch.dryrun``'s one-device prediction of the peak of
    ROOFLINE_ARCH's training step at the lm train phase's 4 x 512 tokens,
    held against the peak that phase measured."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_of

    shape = ShapeConfig(f"train_{LM_TRAIN_BATCH}x{LM_TRAIN_SEQ}",
                        LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    rec = dryrun.run_one(ROOFLINE_ARCH, shape.name, shape=shape,
                         mesh=mesh_of((1, 1)))
    predicted = rec["memory"]["per_device_bytes"]
    peak = measured["lm train"][ROOFLINE_ARCH]["peak_memory_bytes"]
    ratio = predicted / peak
    emit({"phase": "roofline peak prediction", "arch": ROOFLINE_ARCH,
          "shape": shape.name, "mesh": rec["mesh"],
          "predicted_bytes": predicted, "state_bytes": rec["memory"][
              "state_bytes"], "activation_bytes": rec["memory"][
              "activation_bytes"], "measured_peak_bytes": peak,
          "ratio": ratio, "headroom": PEAK_MODEL_HEADROOM,
          "dryrun_s": rec["run_s"]})
    if not 1 / PEAK_MODEL_HEADROOM <= ratio <= PEAK_MODEL_HEADROOM:
        fail(f"roofline: the dry-run's peak {predicted} is {ratio:.3g} x the "
             f"measured {peak}")


def roofline_phase(torch, tree, batches, measured) -> None:
    """Each FULL-width path the phases above timed, against the roofline of
    its counted work; the count on the card against the CPU's; the
    dry-run's peak against a measured one. ``measured``: what those phases
    measured, by phase ("serve" and "train" by plan, "lm serve" and "lm
    train" by arch); nothing is timed again."""
    t0 = time.perf_counter()
    _count_parity(torch, tree, batches)
    _fold_counts(torch, tree, batches, measured)
    _lm_counts(torch, measured)
    _peak_prediction(torch, measured)
    torch.cuda.empty_cache()
    emit({"phase": "roofline seconds", "seconds": time.perf_counter() - t0})


def dap_phases(torch, tree, batches, seen):
    """The DAP and TP phases; the kernel calls at their shard shapes join
    ``seen`` (checked by ``kernel_phase``). Returns their launches."""
    t0 = time.perf_counter()
    launches = dap_nccl1_phase(torch, tree, batches[0])
    dap_seen, dap_launches, ranks = dap2_phase(torch, tree, batches[0])
    tp_seen, tp_launches = tp2_phase(torch, tree, ranks)
    for shard_seen, l in ((dap_seen, dap_launches), (tp_seen, tp_launches)):
        launches.update(l)
        for k, calls in shard_seen.items():
            for sig, where in calls.items():
                seen.setdefault(k, {}).setdefault(sig, where)
    emit({"phase": "dap phases", "seconds": time.perf_counter() - t0})
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "flags": _build.NVCC_FLAGS})
    # Registers, spills and static shared memory of every kernel's entries
    # (dynamic shared memory is sized at launch: see their sources).
    for k in SOURCES:
        emit({"phase": "ptxas", "source": SOURCES[k][0],
              "entries": ptxas_report(_build.BUILD_LOG.get(k, ""))})

    tree, batches = init_phase(torch)
    seen = survey_phase(torch, tree, batches)
    lm_survey(torch, seen)
    launches = dap_phases(torch, tree, batches, seen)
    timer = Timer(torch)
    checks = kernel_phase(torch, timer, seen)
    emit({"phase": "kernel_checks", "summary": {
        k: {"cases": sum(r["kernel"] == k for r in checks),
            "max_abs_err": max(r["max_abs_err"] for r in checks
                               if r["kernel"] == k),
            "max_rel_err": max(r["max_rel_err"] for r in checks
                               if r["kernel"] == k),
            "tol": TOL[k]} for k in TOL}})

    del timer
    launches["serve"], latencies = serve_phase(torch, tree, batches)
    launches["serve attention-oracle"], oracle_latencies = serve_phase(
        torch, tree, batches, "attention-oracle", baseline=latencies)
    measured = {"serve": {"default": latencies,
                          "attention-oracle": oracle_latencies}}
    smoke_phase(torch)
    lm_launches, measured["lm serve"] = lm_serve_phase(torch)
    launches.update(lm_launches)
    lm_launches, measured["lm train"] = lm_train_phase(torch)
    launches.update(lm_launches)
    parity_phase(torch, tree, batches)
    launches["train"], nothing = train_phase(torch)
    launches["train attention-oracle"], oracle_train = train_phase(
        torch, "attention-oracle", n_steps=2)
    measured["train"] = {"default": nothing["warm_step_s"],
                         "attention-oracle": oracle_train["warm_step_s"]}
    launches["train dots"] = train_dots_phase(torch, nothing)
    resume_phase(torch)
    for plan in ("default", "attention-oracle"):
        for point in ("random", "off-clamp"):
            train_parity_phase(torch, tree, plan, point)
    chunk = long_phase(torch, tree)
    long_kernel_phase(torch, Timer(torch), chunk)
    analysis_phase(torch)
    examples_phase(torch)
    roofline_phase(torch, tree, batches, measured)

    # One line for every ported kernel, at its heaviest main-path shape;
    # its launches are those of its own path (KERNEL_PATHS), and it lists
    # those of every path.
    kernels = []
    for k, (src, replaces) in SOURCES.items():
        timed = [r for r in checks if r["kernel"] == k and "ms" in r]
        top = max(timed, key=lambda r: r["bound_ms"])
        path = KERNEL_PATHS.get(k, "serve")
        if launches[path][k] == 0:
            fail(f"{k} never launched on its path ({path})")
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[path][k], "launches_path": path,
            "launches_by_path": {p: n[k] for p, n in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in checks
                               if r["kernel"] == k),
            "tol": TOL[k],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library_call": top.get("library_call"),
            "shape": top["shape"], "dtype": top["dtype"], "case": top["case"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
