"""A copy of the benchmark in a temporary directory with a tiny
configuration and its cells added as new files, as a later change adds
them: nothing that is there is edited."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TINY = {"d_msa": 32, "d_pair": 16, "msa_heads": 4, "pair_heads": 2,
        "head_dim": 8, "opm_dim": 8, "tri_mult_dim": 16, "n_blocks": 2,
        "c_s": 32, "ipa_heads": 4, "ipa_c_hidden": 8, "n_qk_points": 2,
        "n_v_points": 2, "n_iterations": 2, "n_recycle": 1,
        "compute_dtype": "float32"}
CELLS = {"tiny.train": ("af_full.train_initial", {"n_res": 12, "n_seq": 6,
                                                   "pool": 4}),
         "tiny.fold": ("af_full.fold_mix", {"lengths": [9, 12, 14, 16],
                                            "buckets": [12, 16], "n_seq": 6,
                                            "dist_rows": 10})}


def add_json(path: Path, obj) -> None:
    if path.exists():
        raise FileExistsError(f"{path} exists: only new files are added")
    path.write_text(json.dumps(obj, indent=1))


def tiny_copy(tmp: Path, dtype: str = "float32") -> Path:
    """The checkout's root of a copy of ``BENCHMARK.json`` and
    ``portbench/`` with the tiny configuration and the cells of ``CELLS``
    added."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    full = json.loads((BENCH / "configs" / "alphafold-full.json").read_text())
    add_json(root / "portbench" / "configs" / "tiny.json",
             {**full, **TINY, "name": "tiny", "compute_dtype": dtype})
    manifest["configs"].append({"name": "tiny", "source": "test",
                                "file": "portbench/configs/tiny.json",
                                "reduced": [], "why": "tests"})
    for name, (like, params) in CELLS.items():
        w = json.loads((BENCH / "workloads" / f"{like}.json").read_text())
        w.update(name=name, config="tiny", trace_items=2)
        w["params"] = {**w["params"], **params}
        add_json(root / "portbench" / "workloads" / f"{name}.json", w)
        manifest["workloads"].append({"name": name, "config": "tiny",
                                      "traffic": w["traffic"], "chips": 1,
                                      "why": "tests"})
        like_cells = {like}
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like_cells & set(m.get("workloads", ())):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
