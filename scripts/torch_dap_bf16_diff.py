#!/usr/bin/env python3
"""Where the bf16 Evoformer under DAP first departs from the one-device port.

    python3 scripts/torch_dap_bf16_diff.py [--ranks 2] [--out PATH]

On one card, at FULL widths (d_msa 256, d_pair 128), r = 256, s = 128,
batch 1, bf16, with the weights ``chip_smoke.py`` uses (the port's init,
every leaf randomised from a seed):

1. ``ops``: each bf16 op of the block on each rank's shard (1/N of the
   rows, contiguous, as DAP hands it over) and on the whole tensor, in this
   process. The row counts whole and shard differ and nothing else does, so
   an op whose numbers depend on how many rows it is given shows here.
2. ``modules``: N ranks (gloo on the one card) run each sub-module of the
   block, then the stack at 1 and 2 blocks, under DAP; each rank holds its
   shard against the slice of the same module run whole with ``LocalDist``
   in the same process, on the same inputs.
3. ``folds``: the whole fold (``FastFold``, the request ``chip_smoke.py``
   serves first) at several depths and recycling counts, under the
   whole-model DAP plan against the default plan with ``LocalDist``, beside
   how far the one-device port moves between its own plans (attention- and
   triangle-oracle against default): the relative error max|got - want| /
   max(1, max|want|) of each output.
4. ``tp``: the Evoformer stack under the TP baseline at several depths
   against the one-device stack under attention-oracle (TP materialises its
   scores too), beside the one-device stack's own default-plan spread.

Every case prints one JSON line: the elements that differ, the largest
absolute difference and the largest magnitude of the whole run's slice.
The card's name and power limit come first. ``--out`` also writes every
line to a file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
B, S, R = 1, 128, 256
# (blocks, n_recycle) of the ``folds`` part.
FOLD_POINTS = ((1, 0), (2, 0), (2, 3), (4, 0), (8, 0), (8, 3), (16, 0),
               (16, 3))
TP_DEPTHS = (2, 8, 16)
FOLD_KEYS = ("coords", "msa_logits", "distogram_logits")


def _diff(got, want) -> dict:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return {"n_diff": int((g != w).sum()), "numel": w.numel(),
            "max_abs_diff": float(d.max()), "max_abs": float(w.abs().max())}


def _tree():
    from repro_torch.configs import FULL
    from repro_torch.exec import FastFold
    from repro_torch.weights import params_to_numpy, randomize_tree

    return randomize_tree(params_to_numpy(FastFold(FULL).init(seed=SEED)),
                          SEED + 1)


def _first(tree, n: int):
    """The first ``n`` blocks of a stacked block tree."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


def _inputs(torch, dtype):
    """Whole Evoformer inputs from a seed: MSA and pair N(0, 1), an MSA
    mask dropping ~10%, the last 20 residues padding."""
    from repro_torch.configs import FULL

    evo = FULL.evoformer
    gen = torch.Generator().manual_seed(SEED + 9)
    msa = torch.randn((B, S, R, evo.d_msa), generator=gen).to(dtype)
    pair = torch.randn((B, R, R, evo.d_pair), generator=gen).to(dtype)
    msa_mask = (torch.rand((B, S, R), generator=gen) < 0.9).float()
    seq_mask = torch.ones((B, R))
    seq_mask[:, -20:] = 0.0
    pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
    return [t.to("cuda") for t in (msa, pair, msa_mask, seq_mask, pair_mask)]


def op_cases(torch, n: int):
    """Each bf16 op on the whole tensor and on each 1/N of its rows."""
    from repro_torch.kernels import ops

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def rnd(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda",
                                    dtype=f32)).to(dtype)

    rank = [0]

    def shard(x, axis):
        size = x.shape[axis] // n
        return x.narrow(axis, rank[0] * size, size).contiguous()

    rows = []

    def case(name, fn, whole_args, shard_args, axis):
        """``shard_args``: a function of no argument giving the shards of
        the rank in ``rank[0]``."""
        want = fn(*whole_args)
        for rank[0] in range(n):
            size = want.shape[axis] // n
            rows.append(dict(case=name, rank=rank[0], **_diff(
                fn(*shard_args()), want.narrow(axis, rank[0] * size,
                                               size))))

    msa = rnd(B, S, R, 256)
    pair = rnd(B, R, R, 128)
    for name, x, axis, d_out in (("msa s shard", msa, 1, 768),
                                 ("msa r shard", msa, 2, 768),
                                 ("pair i shard", pair, 1, 512)):
        w = rnd(x.shape[-1], d_out, scale=x.shape[-1] ** -0.5)
        case(f"gemm {name} ({x.shape[-1]}x{d_out})", lambda t: t @ w,
             (x,), lambda: (shard(x, axis),), axis)
        gamma, beta = rnd(x.shape[-1], dtype=f32), rnd(x.shape[-1], dtype=f32)
        case(f"K1 layer_norm {name}",
             lambda t: ops.layer_norm(t, gamma, beta), (x,),
             lambda: (shard(x, axis),), axis)
    g, v = rnd(B, R, R, 128), rnd(B, R, R, 128)
    bg = rnd(128, dtype=f32)
    case("K2 bias_sigmoid_mul pair i shard", lambda a, b: ops.bias_sigmoid_mul(
        a, bg, b), (g, v), lambda: (shard(g, 1), shard(v, 1)), 1)

    # K5: q/k/v column slices of one merged projection, as project_qkv
    # hands them over; the bias whole on every rank, the mask sharded.
    def attention(y, bias, mask, h):
        q, k, v_ = torch.split(y, [h * 32] * 3, dim=-1)
        return ops.fused_attention(
            q.unflatten(-1, (h, 32)), k.unflatten(-1, (h, 32)),
            v_.unflatten(-1, (h, 32)), bias=bias, mask=mask,
            scale=32 ** -0.5)

    for name, grp, seq, h, with_bias in (("MSA row", S, R, 8, True),
                                         ("MSA col", R, S, 8, False),
                                         ("triangle", R, R, 4, True)):
        y = rnd(B, grp, seq, 3 * h * 32)
        bias = rnd(B, h, seq, seq) if with_bias else None
        mask = torch.where(torch.rand((B, grp, seq), generator=gen,
                                      device="cuda") < 0.9, 0.0, -1e9)
        case(f"K5 fused_attention {name} G {grp} -> {grp // n}",
             lambda y_, m_: attention(y_, bias, m_, h), (y, mask),
             lambda: (shard(y, 1), shard(mask, 1)), 1)

    # K7: a and its gate are column halves of merged projections.
    c = 128
    ab, gg = rnd(B, R, R, 2 * c), rnd(B, R, R, 2 * c)
    pmask = (torch.rand((B, R, R), generator=gen, device="cuda") < 0.9).float()
    b_full = rnd(B, R, R, c)
    g_lin = rnd(B, R, R, 128)
    tw = [rnd(c, dtype=f32), rnd(c, dtype=f32),
          rnd(c, 128, dtype=f32, scale=c ** -0.5), rnd(128, dtype=f32),
          rnd(128, dtype=f32)]

    def tri(ab_, gg_, m_, gl_):
        return ops.fused_triangle_mult(
            ab_[..., :c], gg_[..., :c], m_, b_full, tw[0], tw[1], tw[2],
            tw[3], gl_, tw[4])

    case(f"K7 triangle_mult I {R} -> {R // n}", tri, (ab, gg, pmask, g_lin),
         lambda: (shard(ab, 1), shard(gg, 1), shard(pmask, 1),
                  shard(g_lin, 1)), 1)

    # K8: a sharded on r (I), b gathered whole (J).
    oc = 32
    a = rnd(B, S, R, oc)
    b = rnd(B, S, R, oc)
    mmask = (torch.rand((B, S, R), generator=gen, device="cuda") < 0.9).float()
    ow = rnd(oc * oc, 128, dtype=f32, scale=(oc * oc) ** -0.5)
    obias = rnd(128, dtype=f32)
    case(f"K8 outer_product_mean I {R} -> {R // n}",
         lambda a_, m_: ops.fused_outer_product_mean(a_, b, m_, mmask, ow,
                                                     obias),
         (a, mmask), lambda: (shard(a, 2), shard(mmask, 2)), 1)
    return rows


def module_rank(rank, world, init_file, tree):
    """One rank: every sub-module of the block and the stack at 1 and 2
    blocks under DAP, each against the same computation whole with
    ``LocalDist`` (this process, the same inputs); then the ``folds``
    part. ``tree``: the model's weights, the Evoformer cut to the deepest
    of ``FOLD_POINTS``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.core import evoformer as E
    from repro_torch.exec.plan import preset, use_plan
    from repro_torch.weights import params_from_numpy

    D.form_group(rank, world, init_file, backend="gloo", device="cuda",
                 timeout_s=300)
    d, loc = D.ProcessGroupDist(), D.LocalDist()
    cfg = FULL.evoformer
    params = params_from_numpy(
        {"evoformer": _first(tree["evoformer"], 2)},
        device="cuda")["evoformer"]
    p = params[0]
    msa, pair, msa_mask, seq_mask, pair_mask = _inputs(torch, torch.bfloat16)

    def sh(x, axis):
        return d.shard(x, axis=axis)

    def tr(x, dist):
        return E.transpose_pair(x, dist)

    cases = {
        "msa_row": (lambda m, z, dd: E.msa_row_attention(
            p["msa_row"], m, z, seq_mask, cfg, dist=dd),
            (msa, pair), (sh(msa, 1), sh(pair, 1)), 1),
        "msa_col": (lambda m, mk, dd: E.msa_col_attention(
            p["msa_col"], m, mk, cfg, dist=dd),
            (msa, msa_mask), (sh(msa, 2), sh(msa_mask, 2)), 2),
        "msa_trans": (lambda m, dd: E.msa_transition(p["msa_trans"], m),
                      (msa,), (sh(msa, 2),), 2),
        "opm": (lambda m, mk, dd: E.outer_product_mean(
            p["opm"], m, mk, cfg, dist=dd),
            (msa, msa_mask), (sh(msa, 2), sh(msa_mask, 2)), 1),
        "tri_mult_out": (lambda z, pm, dd: E.triangle_mult_outgoing(
            p["tri_mult_out"], z, pm, cfg, dist=dd),
            (pair, pair_mask), (sh(pair, 1), sh(pair_mask, 1)), 1),
        "tri_mult_in": (lambda z, pm, dd: E.triangle_mult_incoming(
            p["tri_mult_in"], tr(z, dd), tr(pm, dd), cfg, dist=dd),
            (pair, pair_mask), (sh(pair, 1), sh(pair_mask, 1)), 1),
        "tri_attn_start": (lambda z, dd: E.triangle_attention(
            p["tri_attn_start"], z, seq_mask, cfg, dist=dd),
            (pair,), (sh(pair, 1),), 1),
        "tri_attn_end": (lambda z, dd: tr(E.triangle_attention(
            p["tri_attn_end"], tr(z, dd), seq_mask, cfg, dist=dd), dd),
            (pair,), (sh(pair, 1),), 1),
        "pair_trans": (lambda z, dd: E.transition(
            p["pair_trans"]["mlp"], E.layer_norm(p["pair_trans"]["ln"], z)),
            (pair,), (sh(pair, 1),), 1),
    }
    rows = []
    with use_plan(preset("default")), torch.inference_mode():
        for name, (fn, whole, shards, axis) in cases.items():
            want = fn(*whole, loc)
            got = fn(*shards, d)
            size = want.shape[axis] // world
            rows.append(dict(case=name, rank=rank, **_diff(
                got, want.narrow(axis, rank * size, size))))
        for n_blocks in (1, 2):
            c = dataclasses.replace(cfg, n_blocks=n_blocks)
            wm, wz = E.evoformer_stack(params[:n_blocks], msa, pair, msa_mask,
                                       seq_mask, pair_mask, cfg=c, dist=loc)
            gm, gz = E.evoformer_stack(
                params[:n_blocks], sh(msa, 1), sh(pair, 1), sh(msa_mask, 1),
                seq_mask, sh(pair_mask, 1), cfg=c, dist=d)
            for what, got, want in (("msa", gm, wm), ("pair", gz, wz)):
                size = want.shape[1] // world
                rows.append(dict(case=f"stack {n_blocks} block(s) {what}",
                                 rank=rank, **_diff(
                                     got, want.narrow(1, rank * size, size))))
    return rows + fold_cases(torch, rank, tree) + tp_cases(torch, rank, tree)


def _rel(got, want) -> float:
    return (float((got.float() - want.float()).abs().max())
            / max(1.0, float(want.float().abs().max())))


def fold_cases(torch, rank, tree):
    """The ``folds`` part on this rank (the DAP fold runs on every rank;
    rank 0 reports)."""
    from repro_torch.configs import FULL
    from repro_torch.data import protein_batches
    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import ExecutionPlan, KernelPolicy, preset
    from repro_torch.weights import params_from_numpy

    batch = next(protein_batches(batch=1, n_seq=S, n_res=R,
                                 seed=SEED + 2)).as_dict()
    plans = {"default": preset("default"),
             "attention-oracle": ExecutionPlan(
                 kernels=KernelPolicy(attention="oracle")),
             "triangle-oracle": preset("triangle-oracle"),
             "dap": preset("default").with_parallel(backend="gspmd")}
    rows = []
    for n_blocks, n_recycle in FOLD_POINTS:
        cfg = dataclasses.replace(
            FULL, n_recycle=n_recycle, evoformer=dataclasses.replace(
                FULL.evoformer, n_blocks=n_blocks))
        params = params_from_numpy(dict(tree, evoformer=_first(
            tree["evoformer"], n_blocks)), device="cuda")
        out = {}
        for name, plan in plans.items():
            if name != "dap" and rank != 0:
                continue
            o = FastFold(cfg, plan=plan).forward(params, batch)
            out[name] = {k: o[k].float() for k in FOLD_KEYS}
        if rank != 0:
            continue
        want = out.pop("default")
        for name, got in out.items():
            rows.append({"case": f"fold {n_blocks} blocks n_recycle "
                                 f"{n_recycle}: {name} vs default",
                         "rank": rank, "rel_err": {
                             k: _rel(got[k], want[k]) for k in FOLD_KEYS},
                         "max_abs": {k: float(want[k].abs().max())
                                     for k in FOLD_KEYS}})
    return rows


def tp_cases(torch, rank, tree):
    """The ``tp`` part on this rank (rank 0 reports)."""
    from repro_torch.configs import FULL
    from repro_torch.core import dist as D
    from repro_torch.core.evoformer import evoformer_stack
    from repro_torch.core.tp import tp_evoformer_stack
    from repro_torch.exec.plan import (ExecutionPlan, KernelPolicy, preset,
                                       use_plan)
    from repro_torch.weights import params_from_numpy

    xs = _inputs(torch, torch.bfloat16)
    oracle = ExecutionPlan(kernels=KernelPolicy(attention="oracle"))
    rows = []
    with torch.inference_mode():
        for n_blocks in TP_DEPTHS:
            cfg = dataclasses.replace(FULL.evoformer, n_blocks=n_blocks)
            params = params_from_numpy({"evoformer": _first(
                tree["evoformer"], n_blocks)}, device="cuda")["evoformer"]
            with use_plan(preset("default")):
                tm, tz = tp_evoformer_stack(None, cfg, remat=False)(params,
                                                                    *xs)
            if rank != 0:
                continue
            out = {}
            for name, plan in (("attention-oracle", oracle),
                               ("default", preset("default"))):
                with use_plan(plan):
                    out[name] = evoformer_stack(params, *xs, cfg=cfg,
                                                dist=D.LocalDist())
            (wm, wz), (dm, dz) = out["attention-oracle"], out["default"]
            rows.append({"case": f"tp stack {n_blocks} blocks",
                         "rank": rank, "rel_err": {
                             "msa": _rel(tm, wm), "pair": _rel(tz, wz)},
                         "default_vs_attention_oracle": {
                             "msa": _rel(dm, wm), "pair": _rel(dz, wz)}})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_dap_bf16_diff: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import dist as D
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lines = [{"device": smi, "ranks": args.ranks}]
    _build.build_all()
    with torch.inference_mode():
        lines += [dict(part="ops", **r) for r in op_cases(torch, args.ranks)]
    tree = _tree()
    tree["evoformer"] = _first(tree["evoformer"],
                               max(b for b, _ in FOLD_POINTS))
    for rows in D.run_ranks(module_rank, args.ranks, tree, timeout_s=600):
        lines += [dict(part="modules", **r) for r in rows]
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
