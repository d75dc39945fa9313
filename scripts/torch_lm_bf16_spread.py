#!/usr/bin/env python3
"""How far the bf16 prefill logits of a full-width decoder LM move between
the default plan (the LayerNorm kernel K1 at every norm) and the oracle
plan (its plain version), over several weight seeds and prompt lengths.

    PYTHONPATH=src python scripts/torch_lm_bf16_spread.py \\
        [--arch musicgen-medium] [--seeds 40 41 42 43 44 45] \\
        [--lens 32 64 128 256 512] [--cut-layers 2] \\
        [--out chiprun_out/lm_spread.jsonl]

For each weight seed the weights are drawn on the card as ``chip_smoke.py``
draws them (``random_params_like`` over the init's tree, fp32), and for each
prompt length one prompt is drawn by ``lm_batches`` (Zipf tokens). Each
prompt runs one bf16 prefill under each plan and one fp32 prefill under the
oracle plan. Prints a JSON line a reading:

* ``plans``: max|default - oracle| / max(1, max|oracle|), bf16: the measure
  ``chip_smoke.py``'s lm serve phase gates at 2e-2;
* ``bf16_vs_fp32``: the same measure between the oracle's bf16 and fp32
  logits, the size of bf16's own rounding through the whole stack;
* ``plans_cut``: ``plans`` on the model cut to its first ``--cut-layers``
  layers (the same weights), the reading ``chip_smoke.py`` gates;
* ``control_cut``: the cut's oracle logits with the plain LayerNorm's
  ``beta`` left out in the first layer's first norm, against the cut's
  oracle: the fault the cut gate must reject;

then one summary line (the largest, the median, and how many readings lie
over 2e-2; for the cut, whether its largest reading lies under half the
limit, the rule for keeping its gate, and the smallest control), and the
card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

GATE = 2e-2


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return (g - w).abs().max().item() / max(1.0, w.abs().max().item())


def cut_model(params, cfg, n_layers: int):
    """(the first ``n_layers`` layers' weights, the same with ``beta``
    left out of the first layer's first norm, the cut config): the
    weights shared with ``params``."""
    import dataclasses

    layers = params["stages"][0][:n_layers]
    layer0 = dict(layers[0])
    layer0["ln1"] = {**layer0["ln1"],
                     "beta": torch.zeros_like(layer0["ln1"]["beta"])}
    return ({**params, "stages": [layers]},
            {**params, "stages": [[layer0] + layers[1:]]},
            dataclasses.replace(cfg, n_layers=n_layers))


def main(argv=None) -> int:
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.exec.plan import preset, use_plan
    from repro_torch.models.decoder import init_model, model_forward
    from repro_torch.weights import random_params_like

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="musicgen-medium")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[40, 41, 42, 43, 44, 45])
    ap.add_argument("--lens", type=int, nargs="+",
                    default=[32, 64, 128, 256, 512])
    ap.add_argument("--cut-layers", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    cfg = get_config(args.arch)
    with torch.device("meta"):
        skeleton = init_model(torch.Generator(), cfg)
    lines = []

    def out(row):
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)

    readings = []
    for seed in args.seeds:
        params = random_params_like(skeleton, seed, device="cuda")
        for i, n in enumerate(args.lens):
            prompt = torch.as_tensor(
                next(lm_batches(vocab=cfg.vocab, batch=1, seq=n,
                                seed=20 + i)).tokens, dtype=torch.long,
                device="cuda")
            logits = {}
            with torch.no_grad():
                for name, dtype in (("default", torch.bfloat16),
                                    ("oracle", torch.bfloat16),
                                    ("oracle fp32", torch.float32)):
                    with use_plan(preset(name.split()[0])):
                        logits[name] = model_forward(
                            params, prompt, cfg, mode="prefill",
                            max_cache_len=max(args.lens),
                            compute_dtype=dtype)["logits"]
                cut = cut_model(params, cfg, args.cut_layers)
                for name in ("default", "oracle", "control"):
                    with use_plan(preset(name.replace("control",
                                                      "oracle"))):
                        logits[f"{name} cut"] = model_forward(
                            cut[name == "control"], prompt, cut[2],
                            mode="prefill")["logits"]
            row = {"arch": args.arch, "seed": seed, "prompt_len": n,
                   "plans": rel(logits["default"], logits["oracle"]),
                   "bf16_vs_fp32": rel(logits["oracle"],
                                       logits["oracle fp32"]),
                   "max_abs_oracle": logits["oracle"].float().abs().max()
                   .item(),
                   "cut_layers": args.cut_layers,
                   "plans_cut": rel(logits["default cut"],
                                    logits["oracle cut"]),
                   "control_cut": rel(logits["control cut"],
                                      logits["oracle cut"])}
            readings.append(row)
            out(row)
        del params
        torch.cuda.empty_cache()
    plans = [r["plans"] for r in readings]
    floor = [r["bf16_vs_fp32"] for r in readings]
    cut = [r["plans_cut"] for r in readings]
    control = [r["control_cut"] for r in readings]
    out({"summary": args.arch, "readings": len(plans), "plans_max": max(plans),
         "plans_median": statistics.median(plans), "plans_min": min(plans),
         "over_gate": sum(p > GATE for p in plans), "gate": GATE,
         "bf16_vs_fp32_max": max(floor),
         "bf16_vs_fp32_median": statistics.median(floor),
         "cut_layers": args.cut_layers, "plans_cut_max": max(cut),
         "plans_cut_median": statistics.median(cut),
         "cut_under_half_gate": max(cut) < GATE / 2,
         "control_cut_min": min(control),
         "control_cut_over_gate": sum(c > GATE for c in control)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out({"card": smi})
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
