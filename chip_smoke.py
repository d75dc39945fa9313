#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel built from ``src/repro_torch/csrc`` by nvcc;
  3. survey  — every distinct call the FULL-width main path makes to a
               kernel (shape, dtype, memory layout), recorded on a forward
               cut to one block for each served request's shape;
  4. kernels — each kernel against its plain PyTorch version on the card, at
               every surveyed call and at edge cases, in fp32 and bf16, with
               the stated tolerances; kernel, plain and library-call times
               (CUDA events, cold L2, median of 20 runs) beside the bound for
               the same work;
  5. serve   — ``FastFold(FULL).serve`` on three requests at full width
               (48 blocks, n_recycle = 3) with every weight randomised from
               a seed, after an uncounted warm-up pass at each shape: outputs
               finite, launch counts equal to the count the config gives;
  6. parity  — the same model cut to 2 blocks and no recycling, in fp32, on
               every served request, once on the card (the kernels) and once
               with ``device="cpu"`` (the plain versions), held together.
The last two lines are the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that. It needs the repository's ``src/`` beside it and a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Tolerances, kernel vs plain version on the same inputs on the card:
# max|kernel - plain| <= TOL * max(1, max|plain|). fp32: the same function
# summed in another order (attention sums D and Skv terms in another order
# than the plain version's GEMMs). bf16: one rounding of the output is
# 2**-8 relative, and attention rounds p before its PV product at a
# different point (unnormalised, see the kernel's note) than the plain
# version (normalised).
TOL = {
    "layer_norm": {"float32": 1e-5, "bfloat16": 1e-2},
    "bias_sigmoid_mul": {"float32": 1e-5, "bfloat16": 1e-2},
    "flash_attention_fwd": {"float32": 1e-4, "bfloat16": 2e-2},
}
LSE_TOL = 1e-4
# Whole forward, fp32, card (kernels) vs CPU (plain versions), 2 blocks:
# max|card - cpu| <= E2E_TOL * max(1, max|cpu|), coordinates taken over the
# real residues of a padded request.
E2E_TOL = 1e-3

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

SOURCES = {
    "layer_norm": ("src/repro_torch/csrc/layer_norm.cu",
                   "src/repro/kernels/layer_norm.py:70"),
    "bias_sigmoid_mul": ("src/repro_torch/csrc/bias_sigmoid_mul.cu",
                         "src/repro/kernels/fused_elementwise.py:43"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention_fwd.cu",
                            "src/repro/kernels/flash_attention.py:128"),
}


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved: int, ops: float, dtype: str) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate, operations over
    the peak rate of the inputs' type; the larger one, in ms."""
    t_mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple[float, float]:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    scale = max(1.0, w.abs().max().item() if w.numel() else 0.0)
    return err, err / scale


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

REQUESTS = [
    ("r256_s128", dict(n_seq=128, n_res=256, seed=SEED + 2)),
    ("r200_padded_to_256", dict(n_seq=128, n_res=256, n_real=200,
                                seed=SEED + 3)),
    ("r384_s128", dict(n_seq=128, n_res=384, seed=SEED + 4)),
]


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


def survey_phase(torch, tree, batches):
    """Every distinct call the main path makes to a kernel wrapper, recorded
    by wrapping the wrappers ``ops`` calls: one FULL-width forward for each
    request shape, cut to one Evoformer block (every block hands its kernels
    the same shapes) and no recycling (every pass hands them the same
    shapes). Returns {kernel: {signature: request name}}; these launches
    happen before the main path's counts are set to 0."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.kernels import ops
    from repro_torch.weights import params_from_numpy

    ff = FastFold(_cut(FULL, 1))
    params = params_from_numpy(dict(tree, evoformer=_slice_tree(
        tree["evoformer"], 1)), device="cuda")
    seen = {k: {} for k in TOL}
    where = [None]
    orig = (ops.layer_norm_cuda, ops.bias_sigmoid_mul_cuda,
            ops.flash_attention_cuda)

    def ln(x, gamma, beta, eps=1e-5):
        seen["layer_norm"].setdefault(
            (tuple(x.shape), str(x.dtype)[6:]), where[0])
        return orig[0](x, gamma, beta, eps)

    def bsm(g, bg, v):
        seen["bias_sigmoid_mul"].setdefault(
            (tuple(v.shape), str(v.dtype)[6:]), where[0])
        return orig[1](g, bg, v)

    def attn(q, k, v, bias, mask, scale):
        seen["flash_attention_fwd"].setdefault(
            (_layout((q, k, v)), None if bias is None else bias.shape[0],
             mask is not None, str(q.dtype)[6:]), where[0])
        return orig[2](q, k, v, bias, mask, scale)

    ops.layer_norm_cuda, ops.bias_sigmoid_mul_cuda = ln, bsm
    ops.flash_attention_cuda = attn
    try:
        done = set()
        for (name, kw), batch in zip(REQUESTS, batches):
            if (kw["n_res"], kw["n_seq"]) in done:
                continue
            done.add((kw["n_res"], kw["n_seq"]))
            where[0] = name
            ff.forward(params, batch)
        torch.cuda.synchronize()
    finally:
        (ops.layer_norm_cuda, ops.bias_sigmoid_mul_cuda,
         ops.flash_attention_cuda) = orig
    emit({"phase": "survey", "cut": {"n_blocks": 1, "n_recycle": 0},
          "distinct_calls": {k: len(v) for k, v in seen.items()}})
    return seen


def kernel_phase(torch, timer, seen):
    """Each kernel against its plain version at every signature the survey
    found, in fp32 and bf16 (timed in the main path's own dtype), then at
    the edge cases."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_elementwise import bias_sigmoid_mul_cuda
    from repro_torch.kernels.layer_norm import layer_norm_cuda

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    other = {"float32": "bfloat16", "bfloat16": "float32"}

    def randn(shape, dtype="float32", scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale + shift
        return x.to(dts[dtype])

    results = []

    def record(kernel, case, dtype, shape, got, want, timing=None, extra=None):
        err, rel = rel_err(got, want)
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
        c = shape[-1]
        x = randn(shape, dt, 2.0, 0.5)
        gamma = randn((c,), "float32", 0.1, 1.0)
        beta = randn((c,), "float32", 0.1)
        got = layer_norm_cuda(x, gamma, beta)
        want = ref.layer_norm_ref(x, gamma, beta)
        timing = None
        if main:
            g_l, b_l = gamma.to(x.dtype), beta.to(x.dtype)
            t_b, by = bound(nbytes(x, gamma, beta) + nbytes(x), 8.0 * x.numel(),
                            "float32")
            timing = {
                "ms": timer(lambda: layer_norm_cuda(x, gamma, beta)),
                "plain_ms": timer(lambda: ref.layer_norm_ref(x, gamma, beta)),
                "library_ms": timer(lambda: F.layer_norm(x, (c,), g_l, b_l)),
                "bound_ms": t_b, "bound_by": by}
        record("layer_norm", case, dt, shape, got, want, timing,
               {"main_path": main})

    # --- K2 bias·sigmoid·mul.
    def check_bsm(case, shape, dt, main):
        c = shape[-1]
        g = randn(shape, dt, 2.0)
        v = randn(shape, dt)
        bg = randn((c,), "float32")
        got = bias_sigmoid_mul_cuda(g, bg, v)
        want = ref.bias_sigmoid_mul_ref(g, bg, v)
        timing = None
        if main:
            bg_l = bg.to(g.dtype)
            t_b, by = bound(nbytes(g, bg, v) + nbytes(v), 6.0 * v.numel(),
                            "float32")
            timing = {
                "ms": timer(lambda: bias_sigmoid_mul_cuda(g, bg, v)),
                "plain_ms": timer(lambda: ref.bias_sigmoid_mul_ref(g, bg, v)),
                "library_ms": timer(lambda: torch.sigmoid(g + bg_l) * v),
                "bound_ms": t_b, "bound_by": by}
        record("bias_sigmoid_mul", case, dt, shape, got, want, timing,
               {"main_path": main})

    # --- K5 flash-attention forward. q/k/v are views laid out in memory as
    # the main path lays them out (column slices of the merged projection);
    # the key mask drops ~10% of keys and masks every key of n_masked rows,
    # as padded residues do.
    def check_attn(case, layout, nb, wm, n_masked, dt, main):
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
        scale = 1.0 / d ** 0.5
        out, lse = flash_attention_cuda(q, k, v, bias, mask, scale)
        want, want_lse = ref.attention_ref(q, k, v, bias, mask, scale)
        lse_err, lse_rel = rel_err(lse, want_lse)
        if lse_rel > LSE_TOL:
            fail(f"flash_attention_fwd {case} {dt}: lse error {lse_rel:.3g}")
        timing = None
        rep = n // nb if nb else None
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
            t_b, by = bound(nbytes(q, k, v, bias, mask, out, lse),
                            4.0 * n * h * sq * skv * d, dt)
            timing = {
                "ms": timer(lambda: flash_attention_cuda(q, k, v, bias, mask,
                                                         scale)),
                "plain_ms": timer(lambda: ref.attention_ref(q, k, v, bias,
                                                            mask, scale)),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=am, scale=scale)),
                "bound_ms": t_b, "bound_by": by}
        record("flash_attention_fwd", case, dt, (n, sq, skv, h, d), out, want,
               timing, {"main_path": main, "rep": rep, "bias": bool(nb),
                        "mask": wm, "fully_masked_rows": n_masked if wm else 0,
                        "lse_max_rel_err": lse_rel})

    # Every main-path signature in its own dtype (timed), then in the other
    # dtype where the main path has no such call itself.
    checks = {"layer_norm": check_ln, "bias_sigmoid_mul": check_bsm,
              "flash_attention_fwd": lambda case, *a: check_attn(
                  case, *a[:-2], 2, *a[-2:])}
    for kernel, calls in seen.items():
        for sig, req in calls.items():
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

    for dt in dts:
        check_ln("odd_c100", (3, 7, 100), dt, False)
        check_ln("c384", (2, 50, 384), dt, False)
        check_bsm("2d", (1000, 72), dt, False)
        # (case, N, Sq, Skv, H, D, B, mask, fully masked rows)
        for case, n, sq, skv, h, d, nb, wm, nm in [
                ("ragged_skv200", 6, 64, 200, 4, 32, 2, True, 0),
                ("fully_masked_rows", 8, 100, 100, 4, 32, 2, True, 3),
                ("no_bias_no_mask", 4, 130, 130, 2, 32, 0, False, 0),
                ("head_dim16", 4, 40, 40, 2, 16, 4, False, 0)]:
            check_attn(case, qkv_layout(n, sq, skv, h, d), nb, wm, nm, dt,
                       False)
    return results


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def expected_launches(cfg, passes: int) -> dict[str, int]:
    """Launches per forward from the config: per Evoformer block 12
    LayerNorms, 6 gates (4 attention + 2 triangle) and 4 attentions; per pass
    2 LayerNorms in recycling and 2 + 2 per iteration in the structure
    module."""
    nb, ni = cfg.evoformer.n_blocks, cfg.structure.n_iterations
    return {"layer_norm": passes * (12 * nb + 2 + 2 + 2 * ni),
            "bias_sigmoid_mul": passes * 6 * nb,
            "flash_attention_fwd": passes * 4 * nb}


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


def serve_phase(torch, tree, batches):
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.kernels import _build
    from repro_torch.weights import params_from_numpy

    ff = FastFold(FULL)
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
    emit({"phase": "warmup", "n_recycle": 0, "seconds": warm})

    per_request = expected_launches(FULL, FULL.n_recycle + 1)
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
        emit({"phase": "serve", "request": name, "n_res": r, "n_seq": s,
              "n_real": kw.get("n_real", r), "n_recycle": FULL.n_recycle,
              "n_blocks": FULL.evoformer.n_blocks, "latency_s": latencies[name],
              "launches": counts, "expected_launches": per_request,
              "finite": finite, "shapes_ok": shapes_ok,
              "max_abs_coords": out["coords"].abs().max().item()})
        if not (finite and shapes_ok):
            fail(f"serve {name}: outputs not finite or misshapen")
        if counts != per_request:
            fail(f"serve {name}: launches {counts} != expected {per_request}")
    main_launches = {k: _build.LAUNCHES[k] for k in per_request}
    if any(v == 0 for v in main_launches.values()):
        fail(f"a kernel of the main path never launched: {main_launches}")
    del params
    return main_launches, latencies


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def parity_phase(torch, tree, batches):
    """The kernel path against the plain path end to end: the same FULL-width
    model and every served request in fp32, on the card and on the CPU. Only
    the depth is cut (2 blocks, no recycling), to keep the CPU runs short."""
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_from_numpy

    n_blocks = 2
    cfg = _cut(FULL, n_blocks)
    cut = dict(tree, evoformer=_slice_tree(tree["evoformer"], n_blocks))
    ffs = {dev: (FastFold(cfg, device=dev, dtype=torch.float32),
                 params_from_numpy(cut, device=dev)) for dev in ("cuda", "cpu")}
    bad = []
    for (name, kw), batch in zip(REQUESTS, batches):
        outs, secs = {}, {}
        for dev, (ff, params) in ffs.items():
            t0 = time.perf_counter()
            outs[dev] = ff.forward(params, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        row = {"phase": "parity_fp32", "request": name,
               "cut": {"n_blocks": n_blocks, "n_recycle": 0}, "width": "FULL",
               "n_res": kw["n_res"], "n_seq": kw["n_seq"],
               "n_real": kw.get("n_real", kw["n_res"]), "tol": E2E_TOL,
               "seconds": secs}
        ok, real = True, row["n_real"]
        for k in ("coords", "distogram_logits", "msa_logits"):
            got, want = outs["cuda"][k].cpu(), outs["cpu"][k]
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
        if real < row["n_res"]:
            row["cpu_sensitivity"] = _sensitivity(*ffs["cpu"], batch,
                                                  outs["cpu"], real)
        row["ok"] = ok
        emit(row)
        if not ok:
            bad.append(name)
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

    tree, batches = init_phase(torch)
    seen = survey_phase(torch, tree, batches)
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
    launches, latencies = serve_phase(torch, tree, batches)
    parity_phase(torch, tree, batches)

    # One line for every ported kernel, at its heaviest main-path shape.
    kernels = []
    for k, (src, replaces) in SOURCES.items():
        timed = [r for r in checks if r["kernel"] == k and "ms" in r]
        top = max(timed, key=lambda r: r["bound_ms"])
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(r["max_abs_err"] for r in checks
                               if r["kernel"] == k),
            "tol": TOL[k],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": top["shape"], "dtype": top["dtype"], "case": top["case"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
