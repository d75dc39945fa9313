"""No module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro`` (the JAX package) is loaded by a run's imports; the reference
loads nothing of the program either. Names are compared whole, the part
before the first dot: ``repro_torch`` is not ``repro``."""
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _top_levels(code: str) -> set:
    prog = ("import sys\nsys.path[:0] = [%r, %r]\n" % (str(ROOT),
                                                      str(ROOT / "src"))
            + code + "\nimport json\nprint(json.dumps(sorted({m.split('.')[0]"
            " for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_run_imports_no_jax():
    names = _top_levels(
        "import runpy\n"
        "from portbench.harness import core, spec\n"
        "for name in ('af_full.train_initial', 'af_full.fold_mix'):\n"
        "    cell = spec.load_cell(name)\n"
        "    cell.traffic_module()\n"
        "    [cell.metric_reader(m['name']) for m in cell.per_layer]\n"
        "from repro_torch.exec import FastFold\n"
        "from repro_torch.train import make_train_step\n"
        "runpy.run_path(%r, run_name='not_main')\n" % str(BENCH / "run.py"))
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_program():
    names = _top_levels("import portbench.reference.alphafold, "
                        "portbench.reference.train, "
                        "portbench.reference.costs, "
                        "portbench.reference.synthetic")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_modules_compares_whole_names():
    from portbench.harness import core

    assert core.forbidden_modules(["repro_torch.core", "jaxx.y", "torch",
                                   "reprox", "flaxen"]) == []
    assert core.forbidden_modules(["repro.kernels", "jax", "repro_torch",
                                   "flax.linen"]) == ["flax.linen", "jax",
                                                      "repro.kernels"]
