"""repro_torch.analysis: the port's repro-lint rules, its run contracts and
the runner (the counterpart of ``tests/test_analysis.py``).

Every rule and contract is proven BOTH ways: it fires on a deliberately-bad
fixture and stays quiet on the good twin (and on the port's tree). The rules
that read no JAX construct (R001, R002, R003's clocks and host RNGs, R006)
agree with the reference's lint line for line on the same sources. The
contracts are checked on crafted ``RunArtifact``s, then on real runs: the
naive merged-lead gather and a stack that doubles its collectives, on two
gloo ranks, trip them; the full matrix on two CPU ranks and one cell through
``python -m repro_torch.analysis`` are clean.

The reference's ``test_find_gather_then_slice`` becomes
``test_collective_bytes_within`` (its contract is replaced, see
``repro_torch/analysis/__init__``), ``test_count_collective_ops_static``
counts a recorded log, and ``test_bench_contracts_baseline_in_sync`` has no
counterpart: the port checks in no record (``--out`` writes one on request).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis.lint import lint_source as reference_lint_source
from repro_torch.analysis.contracts import (
    CollectiveBudget,
    CollectiveBytesWithin,
    NoMergedAllGather,
    PeakBytesWithin,
    RunArtifact,
    assert_no_merged_allgather,
    check_all,
    find_merged_allgathers,
)
from repro_torch.analysis.lint import lint_source, lint_tree
from repro_torch.core import dist as D
from repro_torch.core.dap import block_collective_bytes
from repro_torch.roofline.analysis import count_collective_ops
import torch_dist_cases as cases

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PORT = os.path.join(SRC, "repro_torch")


def rules_of(src: str, relpath: str) -> list[str]:
    return [f.rule for f in lint_source(textwrap.dedent(src), relpath)]


# ---------------------------------------------------------------------------
# repro-lint rules: each fires on the bad fixture, not on the good twin
# ---------------------------------------------------------------------------


def test_r001_env_access_fires():
    assert rules_of("import os\nos.environ['X'] = '1'\n",
                    "core/foo.py") == ["R001"]
    assert rules_of("import os\nv = os.getenv('X')\n",
                    "serving/engine.py") == ["R001"]
    assert rules_of("import os as _o\n_o.environ.get('X')\n",
                    "core/foo.py") == ["R001"]
    # The port's one read outside the compat module was the kernels' build.
    assert rules_of("import os\nh = os.environ.get('CUDA_HOME')\n",
                    "kernels/_build.py") == ["R001"]


def test_r001_catches_aliased_from_import():
    assert "R001" in rules_of("from os import environ\n", "core/foo.py")
    assert "R001" in rules_of(
        "from os import getenv as ge\nv = ge('X')\n", "core/foo.py")
    assert rules_of("from os import environ as e\nv = e.get('X')\n",
                    "core/foo.py") == ["R001", "R001"]


def test_r001_exempts_envcompat():
    src = "import os\nos.environ['X'] = 'x'\nos.getenv('Y')\n"
    assert rules_of(src, "exec/envcompat.py") == []
    assert rules_of(src, "exec/other.py") == ["R001", "R001"]


def test_r002_bare_except_fires():
    bad = """
    try:
        f()
    except Exception:
        pass
    """
    assert rules_of(bad, "serving/engine.py") == ["R002"]
    assert rules_of("try:\n    f()\nexcept:\n    pass\n",
                    "core/foo.py") == ["R002"]
    assert rules_of("try:\n    f()\nexcept BaseException:\n    raise\n",
                    "core/dist.py") == ["R002"]


def test_r002_allows_named_and_resilience():
    named = """
    try:
        f()
    except BaseException as err:
        report(err)
        if not isinstance(err, Exception):
            raise
    """
    assert rules_of(named, "core/dist.py") == []
    assert rules_of("try:\n    f()\nexcept Exception:\n    pass\n",
                    "resilience/faults.py") == []


@pytest.mark.parametrize("src, rel", [
    ("import time\nt = time.time()\n", "core/evoformer.py"),
    ("import time\nt = time.perf_counter()\n", "kernels/ops.py"),
    ("from time import perf_counter\nt = perf_counter()\n", "layers/mlp.py"),
    ("import random\nx = random.random()\n", "kernels/ops.py"),
    ("import numpy as np\nx = np.random.normal()\n", "memory/autochunk.py"),
    ("import datetime\nt = datetime.datetime.now()\n", "train/loop.py"),
    ("import torch\nx = torch.randn(3)\n", "core/alphafold.py"),
    ("import torch\nx = torch.rand((2, 2), device='cuda')\n", "models/moe.py"),
    ("import torch\ni = torch.randperm(8)\n", "optim/schedules.py"),
    ("import torch\nk = torch.bernoulli(p)\n", "core/evoformer.py"),
    ("import torch\nx = torch.randn_like(y)\n", "core/evoformer.py"),
    ("w = torch.empty(3)\nw.normal_()\n", "layers/params.py"),
    ("w.uniform_(-1, 1)\n", "layers/params.py"),
    ("m.bernoulli_(0.9)\n", "core/evoformer.py"),
    ("import torch.nn.functional as F\ny = F.dropout(x, 0.1)\n",
     "models/decoder.py"),
    ("from torch.nn import functional as F\ny = F.dropout(x, 0.1)\n",
     "models/decoder.py"),
    ("import torch\ny = torch.nn.functional.dropout(x, 0.1)\n",
     "models/decoder.py"),
])
def test_r003_wallclock_and_random_fire_in_traced_code(src, rel):
    assert rules_of(src, rel) == ["R003"], src


def test_r003_scoped_to_traced_modules_and_allows_explicit_generators():
    # launch/resilience/benchmark code may read clocks and host RNGs.
    assert rules_of("import time\nt = time.time()\n",
                    "launch/dryrun.py") == []
    assert rules_of("import random\nrandom.seed(0)\n",
                    "resilience/faults.py") == []
    assert rules_of("import torch\nx = torch.randn(3)\n", "weights.py") == []
    # An explicit torch.Generator is the sanctioned in-model RNG.
    explicit = """
    import torch
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3,), generator=g)
    u = torch.rand((3,), generator=g, device="cpu")
    w = torch.empty(3).normal_(generator=g)
    k = torch.bernoulli(p, generator=g)
    """
    assert rules_of(explicit, "core/alphafold.py") == []


def test_r004_r005_scores_materialized_attention_fires():
    bad = """
    import torch
    import torch.nn.functional as F
    def attend(q, k, v):
        scores = torch.einsum("bgihd,bgjhd->bghij", q, k)
        probs = F.softmax(scores, dim=-1)
        return torch.einsum("bghij,bgjhd->bgihd", probs, v)
    """
    got = rules_of(bad, "core/evoformer.py")
    assert got == ["R004", "R005", "R004"], got
    # The same source outside the pair-stack modules is not in scope.
    assert rules_of(bad, "models/decoder.py") == []


@pytest.mark.parametrize("line", [
    "p = torch.softmax(s, -1)",
    "p = s.softmax(-1)",
    "p = torch.nn.functional.softmax(s, dim=-1)",
    "p = np.einsum('ij,jk->ik', a, b)",
])
def test_r004_r005_torch_spellings(line):
    src = f"import torch\nimport numpy as np\n{line}\n"
    want = "R004" if "einsum" in line else "R005"
    assert rules_of(src, "core/alphafold.py") == [want]
    # The fused ops are what the rules point to.
    assert rules_of("from repro_torch.kernels import ops\n"
                    "p = ops.fused_softmax(s, bias=b, mask=m)\n",
                    "core/evoformer.py") == []


def test_suppressions():
    line = ('import torch\n'
            'o = torch.einsum("ij,jk->ik", a, b)'
            '  # repro-lint: disable=R004\n')
    assert rules_of(line, "core/evoformer.py") == []
    above = ('import torch\n'
             '# repro-lint: disable=R004 -- sanctioned fallback\n'
             'o = torch.einsum("ij,jk->ik", a, b)\n')
    assert rules_of(above, "core/evoformer.py") == []
    multiline = ('import torch\n'
                 'o = torch.einsum("ij,jk->ik", a,\n'
                 '                 b)  # repro-lint: disable=R004\n')
    assert rules_of(multiline, "core/evoformer.py") == []
    whole_file = ('# repro-lint: disable-file=R004\n'
                  'import torch\n'
                  'o = torch.einsum("ij,jk->ik", a, b)\n')
    assert rules_of(whole_file, "core/evoformer.py") == []
    # Suppressing a different rule does not silence this one.
    wrong = ('import torch\n'
             'o = torch.einsum("ij,jk->ik", a, b)'
             '  # repro-lint: disable=R005\n')
    assert rules_of(wrong, "core/evoformer.py") == ["R004"]


def test_r006_print_and_stdout_fire_in_library_modules():
    assert rules_of("print('debug')\n", "serving/engine.py") == ["R006"]
    assert rules_of("import sys\nsys.stdout.write('x')\n",
                    "train/loop.py") == ["R006"]
    assert rules_of("import sys\nsys.stderr.writelines(['x'])\n",
                    "core/foo.py") == ["R006"]


def test_r006_quiet_twin_and_exempt_scopes():
    for rel in ("obs/report.py", "obs/trace.py", "analysis/lint.py",
                "launch/serve.py", "analysis/__main__.py",
                "obs/__main__.py"):
        assert rules_of("print('report line')\n", rel) == []
    quiet = ("def dump(fh, log):\n"
             "    fh.write('x')\n"
             "    log.writelines(['x'])\n")
    assert rules_of(quiet, "serving/engine.py") == []


def test_r006_suppression():
    line = "print('sanctioned')  # repro-lint: disable=R006\n"
    assert rules_of(line, "serving/engine.py") == []
    wrong = "print('sanctioned')  # repro-lint: disable=R003\n"
    assert rules_of(wrong, "serving/engine.py") == ["R006"]


# The reference's own fixtures for the rules that name no JAX construct:
# both lints give the same rules on the same lines.
SHARED_FIXTURES = [
    ("import os\nos.environ['X'] = '1'\n", "core/foo.py"),
    ("import os as _o\n_o.environ.get('X')\nos.getenv('Y')\n",
     "serving/engine.py"),
    ("from os import getenv as ge\nv = ge('X')\n", "core/foo.py"),
    ("import os\nos.environ['X'] = 'x'\n", "exec/envcompat.py"),
    ("try:\n    f()\nexcept Exception:\n    pass\n", "serving/engine.py"),
    ("try:\n    f()\nexcept:\n    pass\n", "resilience/retry.py"),
    ("try:\n    f()\nexcept Exception as e:\n    raise\n", "core/foo.py"),
    ("import time\nt = time.time()\n", "core/evoformer.py"),
    ("import time\nt = time.time()\n", "launch/dryrun.py"),
    ("import random\nx = random.random()\n", "kernels/ops.py"),
    ("import numpy as np\nx = np.random.normal()\n", "memory/autochunk.py"),
    ("import datetime\nt = datetime.datetime.now()\n", "train/loop.py"),
    ("print('debug')\n", "serving/engine.py"),
    ("import sys\nsys.stdout.write('x')\n", "obs/report.py"),
    ("print('x')  # repro-lint: disable=R006\n", "core/foo.py"),
]


@pytest.mark.parametrize("src, rel", SHARED_FIXTURES)
def test_rules_agree_with_the_reference_lint(src, rel):
    ours = [(f.rule, f.line) for f in lint_source(src, rel)]
    theirs = [(f.rule, f.line) for f in reference_lint_source(src, rel)]
    assert ours == theirs


def test_lint_tree_clean_on_head():
    findings = lint_tree(PORT)
    assert not findings, "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------------------
# contracts on crafted records
# ---------------------------------------------------------------------------

MERGED = [(2, 8, 16, 8), (16, 16, 8)]
CLEAN = [(2, 8, 16, 8), (2, 4, 16, 16)]


def test_find_merged_allgathers():
    assert find_merged_allgathers(MERGED, {16}, 3) == [[16, 16, 8]]
    assert find_merged_allgathers(CLEAN, {16}, 3) == []
    # rank gate: a merged lead below min_rank does not count
    assert find_merged_allgathers(MERGED, {16}, 4) == []
    assert find_merged_allgathers([(16, 8)], {16}, 3) == []
    with pytest.raises(AssertionError):
        assert_no_merged_allgather(MERGED, {16}, 3)
    assert_no_merged_allgather(CLEAN, {16}, 3)


def test_collective_bytes_within():
    """The model of a block's forward, held call for call and byte for
    byte: an extra gather (a whole tensor gathered to be re-sliced), a
    missing all-to-all, a kind the model lacks and wrong bytes all show."""
    model = {"all_to_all": {"calls": 8, "bytes": 800},
             "all_gather": {"calls": 7, "bytes": 700}}
    two = {"all_to_all": {"forward": {"calls": 16, "bytes": 1600}},
           "all_gather": {"forward": {"calls": 14, "bytes": 1400},
                          "stack exit": {"calls": 2, "bytes": 64}}}
    c = CollectiveBytesWithin(model, blocks=2)
    assert not c.check(RunArtifact("c", log=two))
    regather = json.loads(json.dumps(two))
    regather["all_gather"]["forward"] = {"calls": 15, "bytes": 1900}
    v = c.check(RunArtifact("c", log=regather))
    assert [x.contract for x in v] == ["CollectiveBytesWithin"] * 2
    missing = {k: v for k, v in two.items() if k != "all_to_all"}
    assert len(c.check(RunArtifact("c", log=missing))) == 2
    extra = dict(two, reduce_scatter={"forward": {"calls": 2, "bytes": 8}})
    assert len(c.check(RunArtifact("c", log=extra))) == 2
    # The backward's duals are not this contract's: it reads the forward.
    grad = json.loads(json.dumps(two))
    grad["all_to_all"]["backward"] = {"calls": 12, "bytes": 1200}
    grad["reduce_scatter"] = {"backward": {"calls": 12, "bytes": 1100}}
    assert not c.check(RunArtifact("c", log=grad))


def test_count_collective_ops_per_block():
    """An eager run's log, every executed call, counted per block; an
    all-reduce counts once, its two halves not."""
    log = {"all_to_all": {"forward": {"calls": 16, "bytes": 1},
                          "backward": {"calls": 12, "bytes": 1}},
           "all_gather": {"forward": {"calls": 14, "bytes": 1},
                          "stack exit": {"calls": 2, "bytes": 1},
                          "all_reduce": {"calls": 2, "bytes": 1}},
           "reduce_scatter": {"backward": {"calls": 12, "bytes": 1},
                              "all_reduce": {"calls": 2, "bytes": 1}},
           "all_reduce": {"backward": {"calls": 2, "bytes": 1}}}
    assert count_collective_ops(log, blocks=2) == {
        "all-to-all": 14.0, "all-gather": 8.0, "reduce-scatter": 6.0,
        "all-reduce": 1.0}
    art = RunArtifact("c", collective_counts=count_collective_ops(log, 2))
    assert not CollectiveBudget(29, 29).check(art)
    assert CollectiveBudget(0, 28).check(art)
    assert CollectiveBudget(30, 44).check(art)


def test_contract_objects():
    art = RunArtifact("cell/x", gathers=MERGED, peak_bytes=1000)
    v = check_all([NoMergedAllGather(frozenset({16}), 3)], art)
    assert len(v) == 1 and v[0].contract == "NoMergedAllGather"
    assert "cell/x" in v[0].render()
    assert not NoMergedAllGather(frozenset({16}), 3).check(
        RunArtifact("c", gathers=CLEAN))

    budget = CollectiveBudget(min_per_block=1, max_per_block=3)
    assert not budget.check(RunArtifact(
        "c", collective_counts={"all-gather": 1.0, "all-to-all": 2.0}))
    over = RunArtifact("c", collective_counts={"all-gather": 5.0})
    assert budget.check(over)
    # below the floor: a pass ran none of its collectives
    assert budget.check(RunArtifact("c", collective_counts={}))


def test_peak_bytes_within_two_sided():
    ok = RunArtifact("c", peak_bytes=1500)
    assert not PeakBytesWithin(modeled_bytes=1000, lo=0.5, hi=2.0).check(ok)
    # measured way above modeled: the model is lying low (over-admission)
    assert PeakBytesWithin(1000, 0.5, 2.0).check(
        RunArtifact("c", peak_bytes=5000))
    # measured way below modeled: the model cries wolf (over-serialization)
    assert PeakBytesWithin(1000, 0.5, 2.0).check(
        RunArtifact("c", peak_bytes=100))
    # the limits sit around a ratio well above 1: a backward's peak of
    # 7x the one-block forward model may not fall to the forward's 0.8x
    grad = PeakBytesWithin(1000, 3.2, 14.5)
    assert not grad.check(RunArtifact("c", peak_bytes=7000))
    assert grad.check(RunArtifact("c", peak_bytes=800))
    assert grad.check(RunArtifact("c", peak_bytes=15000))
    # a run that measured no peak is itself a violation
    assert PeakBytesWithin(1000, 0.5, 2.0).check(RunArtifact("c"))


# ---------------------------------------------------------------------------
# real runs on gloo ranks, and the runner in subprocesses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def controls():
    return D.run_ranks(cases.merged_gather_control, 2, timeout_s=240)


def test_merged_allgather_contract_fires_on_naive_shard(controls):
    """A program that flattens (B, G) into one lead, shards it and gathers
    it whole produces a merged-lead all-gather through ProcessGroupDist on
    every rank; sharding and gathering G does not."""
    for res in controls:
        merged = NoMergedAllGather(frozenset({2 * 8}), min_rank=3)
        assert res["naive"] == [(16, 16, 8)]
        assert merged.check(RunArtifact("naive", gathers=res["naive"]))
        assert res["sharded_g"] == [(2, 8, 16, 8)]
        assert not merged.check(RunArtifact("g", gathers=res["sharded_g"]))


def test_doubled_stack_trips_the_collective_budget(controls):
    """The matrix's DAP stack run once is inside its calibrated budget and
    equal to the block model; a stack that runs its collectives twice a
    block trips both."""
    from repro_torch.analysis import cells

    budget = CollectiveBudget(*cells.COLLECTIVE_BUDGETS["dap_stack"])
    model = CollectiveBytesWithin(block_collective_bytes(
        cells.CFG, batch=cells.B, n_seq=cells.S, n_res=cells.R, n=2),
        blocks=cells.CFG.n_blocks)
    for res in controls:
        once, twice = (RunArtifact(k, log=res[k], collective_counts=(
            count_collective_ops(res[k], cells.CFG.n_blocks)))
            for k in ("stack x1", "stack x2"))
        assert not budget.check(once) and not model.check(once)
        assert budget.check(twice) and model.check(twice)


def test_grad_cell_without_backward_trips_the_collective_floor(controls):
    """The evoformer_grad cell run with ``torch.autograd.grad`` a no-op,
    its backward doing nothing, trips its collective floor: its count
    falls to the forward's 16 a block, under the forward's and the duals'
    28. Its peak stays inside the limits (the forward's saved tensors
    hold most of it), so the floor is the gate that catches it."""
    from repro_torch.analysis import cells

    for res in controls:
        cell = res["grad without backward"]
        art = RunArtifact(cell.name, cell.gathers, cell.peak_bytes,
                          count_collective_ops(cell.log, cell.blocks),
                          cell.log)
        assert sum(art.collective_counts.values()) == 16
        assert [v.contract for v in check_all(cell.contracts, art)] == [
            "CollectiveBudget"]
        lo, hi = cells.PEAK_LIMITS["evoformer_grad"]
        assert lo <= cell.peak_bytes / cell.modeled_bytes <= hi


def test_full_matrix_clean_on_two_cpu_ranks():
    """Every cell under default and oracle on two gloo ranks: no violation,
    each peak ratio and each count inside its cell's limits, the
    DAP stack's collectives equal to ``block_collective_bytes``."""
    from repro_torch.analysis import cells

    violations, rows = cells.run_matrix(("default", "oracle"), ranks=2,
                                        device="cpu")
    assert not violations, [v.render() for v in violations]
    assert len(rows) == 2 * len(cells.CELLS)
    for row in rows:
        cell = row["cell"].split("/")[0]
        lo, hi = cells.PEAK_LIMITS[cell]
        assert lo <= row["ratio"] <= hi, row
        lo, hi = cells.COLLECTIVE_BUDGETS[cell]
        assert lo <= sum(row["collectives"].values()) <= hi, row
        assert row["launches"] == {}            # no kernel on the CPU
        if cell == "dap_stack":
            assert "CollectiveBytesWithin" in row["contracts"]


def run_sub(argv, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return subprocess.run([sys.executable, *argv], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_lint_and_contracts_import_no_torch():
    """The lint pass and the contracts run before any backend starts."""
    out = run_sub(["-c", "import sys\n"
                   "import repro_torch.analysis\n"
                   "from repro_torch.analysis.__main__ import main\n"
                   "rc = main(['--lint-only'])\n"
                   "assert 'torch' not in sys.modules, 'torch imported'\n"
                   "sys.exit(rc)\n"])
    assert out.returncode == 0, out.stdout + out.stderr


def test_runner_lint_clean_on_head():
    out = run_sub(["-m", "repro_torch.analysis", "--lint-only"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro-lint: clean" in out.stdout


def test_runner_fails_on_bad_tree(tmp_path):
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "bad.py").write_text(textwrap.dedent("""
        import os, time
        import torch
        FLAG = os.environ.get("REPRO_X")
        def traced():
            t = time.time()
            noise = torch.randn(3)
            try:
                return t + noise
            except Exception:
                pass
    """))
    out = run_sub(["-m", "repro_torch.analysis", "--lint-only",
                   "--lint-root", str(tmp_path)])
    assert out.returncode == 1, out.stdout + out.stderr
    for rule in ("R001", "R002", "R003"):
        assert rule in out.stdout, (rule, out.stdout)
    assert "core/bad.py:7: R003" in out.stdout


def test_runner_contract_cell_clean_on_head(tmp_path):
    """One contract cell end to end through ``python -m
    repro_torch.analysis`` on two CPU ranks; it writes no file unless
    ``--out`` names one."""
    out = run_sub(["-m", "repro_torch.analysis", "--contracts-only",
                   "--device", "cpu", "--ranks", "2", "--presets",
                   "default", "--cells", "evoformer_fwd"],
                  cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "contract evoformer_fwd/default: ok" in out.stdout
    assert list(tmp_path.iterdir()) == []
