"""Port hygiene and device policy: the PyTorch port imports no JAX and
nothing of the JAX package, runs on the card unless asked for the CPU, sends
CPU tensors to the plain versions without touching a kernel (under every
plan leg, as the leg table of ``kernels/ops.py`` says), and builds its
kernels with nvcc for sm_90a into a directory git ignores."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.exec.plan import ExecutionPlan, KernelPolicy, use_plan
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.fused_elementwise import (bias_dropout_add_cuda,
                                                   bias_sigmoid_mul_cuda)
from repro_torch.kernels.fused_softmax import fused_softmax_cuda
from repro_torch.kernels.layer_norm import layer_norm_cuda
from repro_torch.kernels.triangle import fused_opm_cuda, fused_triangle_cuda
from repro_torch.train import make_train_step
from repro_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "torch_profile_serve.py",
                                         ROOT / "scripts" / "torch_fold_memory.py",
                                         ROOT / "scripts" / "torch_fold_latency.py",
                                         ROOT / "scripts" / "torch_train_alphafold.py",
                                         ROOT / "scripts" / "torch_lm_bf16_spread.py",
                                         # What spawned test ranks import.
                                         ROOT / "tests" / "torch_dist_cases.py",
                                         ] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_package_imports_without_triton_nvcc_or_jax():
    """Every module imports in a fresh interpreter whose PATH holds no nvcc
    and where triton cannot be imported, and leaves JAX unloaded."""
    mods = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys; sys.modules['triton'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert not any(m.split('.')[0] in ('jax', 'repro') "
              "for m in sys.modules), 'jax or repro loaded'\n")
    env = {"PATH": "/nonexistent", "PYTHONPATH": str(ROOT / "src"),
           "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_fastfold_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastFold(SMOKE)
    assert FastFold(SMOKE, device="cpu").device == torch.device("cpu")


def test_trainer_defaults_to_the_card(monkeypatch, tmp_path):
    """``scripts/torch_train_alphafold.py`` runs on the card unless given
    ``--device cpu``: without one it raises before a step or a checkpoint."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_train_alphafold", ROOT / "scripts" / "torch_train_alphafold.py")
    trainer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trainer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU forward, training step and every op's backward launch
    nothing: the counters stay at 0, and no kernel library is even looked
    up."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} reached from a CPU tensor")

    monkeypatch.setattr(_build, "entry", no_kernel)
    _build.reset_launches()
    ff = FastFold(SMOKE, device="cpu")
    batch = next(protein_batches(batch=1, n_seq=3, n_res=6, seed=0)).as_dict()
    out = ff.forward(ff.init(seed=0), batch, n_recycle=0)
    assert torch.isfinite(out["coords"]).all()
    x = torch.randn(4, 8)
    ops.layer_norm(x, torch.ones(8), torch.zeros(8))
    ops.bias_sigmoid_mul(x, torch.zeros(8), x)
    ops.fused_attention(torch.randn(2, 5, 1, 8), torch.randn(2, 5, 1, 8),
                        torch.randn(2, 5, 1, 8))
    ops.fused_triangle_mult(*_triangle_args())
    ops.fused_outer_product_mean(*_opm_args())
    ops.fused_softmax(*_softmax_args())
    keep = torch.ones(4, 1)
    ops.bias_dropout_add(x, torch.zeros(8), x, 0.25, keep)
    # The backwards too: a CPU training step launches nothing either.
    q = torch.randn(2, 5, 1, 8, requires_grad=True)
    ops.fused_attention(q, q, q, bias=torch.randn(1, 1, 5, 5)).sum().backward()
    xg = x.clone().requires_grad_(True)
    ops.bias_dropout_add(xg, None, x, 0.25, keep).sum().backward()
    init, step = make_train_step(ff.loss_fn)
    _, metrics = step(init(ff.init(seed=0)), batch,
                      torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"])
    assert sum(_build.LAUNCHES.values()) == 0


def test_cpu_inference_calls_neither_training_kernel(monkeypatch):
    """A CPU inference forward reaches neither the bias-dropout-add nor the
    attention backward wrapper, nor their plain versions."""
    called = []
    for name in ("bias_dropout_add_cuda", "flash_attention_bwd_cuda"):
        monkeypatch.setattr(ops, name, lambda *a, n=name: called.append(n))
    for name in ("bias_dropout_add_ref", "attention_bwd_ref"):
        monkeypatch.setattr(ops.ref, name, lambda *a, n=name: called.append(n))
    ff = FastFold(SMOKE, device="cpu")
    batch = next(protein_batches(batch=1, n_seq=3, n_res=6, seed=0)).as_dict()
    out = ff.forward(ff.init(seed=0), batch)
    assert torch.isfinite(out["coords"]).all()
    assert called == []


def _triangle_args(c=32, d=32):
    """CPU arguments of the fused triangle op: B=1, I=J=K=5."""
    x = torch.randn(1, 5, 5, c)
    return (x, x, torch.ones(1, 5, 5), x, torch.ones(c), torch.zeros(c),
            torch.randn(c, d), torch.zeros(d), torch.randn(1, 5, 5, d),
            torch.zeros(d))


def _softmax_args():
    """CPU arguments of the fused softmax op, 5D: B=2, G=3, H=2, R=C=5."""
    return (torch.randn(2, 3, 2, 5, 5), torch.randn(2, 2, 5, 5),
            torch.zeros(2, 3, 5), 0.5)


def _opm_args(c=16, d=32):
    """CPU arguments of the fused OPM op: B=1, S=3, I=J=5."""
    x = torch.randn(1, 3, 5, c)
    return (x, x, torch.ones(1, 3, 5), torch.ones(1, 3, 5),
            torch.randn(c * c, d), torch.zeros(d))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        bias_sigmoid_mul_cuda(x, torch.zeros(8), x)
    q = torch.randn(2, 5, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, None, None, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_triangle_cuda(*_triangle_args())
    with pytest.raises(ValueError, match="CUDA"):
        fused_opm_cuda(*_opm_args())
    lse = torch.zeros(2, 1, 5)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, q, q, q, q, lse, None, None, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        bias_dropout_add_cuda(x, None, x, torch.ones(4, 1), 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        fused_softmax_cuda(torch.randn(2, 1, 3, 5), None, None, 1.0)


def test_build_targets_sm90a_in_ignored_dir():
    cmd = _build.nvcc_command("nvcc", "layer_norm", Path("out.so"))
    assert "-gencode" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and "-O3" in cmd
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert _build.library_path("layer_norm").parent == _build.BUILD_DIR
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    sources = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    assert sources == {"layer_norm", "bias_sigmoid_mul", "flash_attention_fwd",
                       "triangle_mult", "outer_product_mean",
                       "flash_attention_bwd", "bias_dropout_add",
                       "fused_softmax"}


FAKE_NVCC = """\
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
start = time.monotonic()
time.sleep(0.5)
open(out + ".span", "w").write(f"{start} {time.monotonic()}")
open(out, "w").write(" ".join(sys.argv[1:]))
"""


def test_build_all_runs_one_nvcc_per_source_in_parallel(tmp_path, monkeypatch):
    """With a stand-in nvcc: every source gets its own process, all running
    at once, and each library appears under its final name only."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    libs = _build.build_all()
    assert set(libs) == set(_build.SIGNATURES)
    for name, path in libs.items():
        assert path.exists() and path.parent == tmp_path / "kernels"
        assert "arch=compute_90a,code=sm_90a" in path.read_text()
        assert path.read_text().endswith(f"csrc/{name}.cu")
    spans = [tuple(map(float, p.read_text().split()))
             for p in (tmp_path / "kernels").glob("*.span")]
    assert len(spans) == len(libs)
    assert not [p for p in (tmp_path / "kernels").glob("*.tmp*")
                if not p.name.endswith(".span")]
    # all builds were running at one moment: the last start precedes the
    # first end
    assert max(s for s, _ in spans) < min(e for _, e in spans), spans
    assert _build.build_all() == libs          # nothing rebuilt


def test_launch_check_raises_and_counts():
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        _build.check("layer_norm", 9)
    assert _build.LAUNCHES["layer_norm"] == 0
    _build.check("layer_norm", 0)
    assert _build.LAUNCHES["layer_norm"] == 1
    _build.reset_launches()
    assert np.sum(list(_build.LAUNCHES.values())) == 0


# ---------------------------------------------------------------------------
# The leg table of kernels/ops.py
# ---------------------------------------------------------------------------

def _op_calls():
    """Each op family's entry point on CPU tensors, with its plain version
    on the same inputs."""
    x = torch.randn(4, 8)
    keep = torch.ones(4, 1)
    q = torch.randn(2, 5, 1, 8)
    sx, sb, sm, sc = _softmax_args()
    sx4, sm4 = sx.reshape(6, 2, 5, 5), sm.reshape(6, 5)
    tri, opm = _triangle_args(), _opm_args()
    return {
        "layer_norm": (lambda: ops.layer_norm(x, torch.ones(8), torch.zeros(8)),
                       lambda: ref.layer_norm_ref(x, torch.ones(8),
                                                  torch.zeros(8))),
        "elementwise": (lambda: ops.bias_dropout_add(x, torch.zeros(8), x,
                                                     0.25, keep),
                        lambda: ref.bias_dropout_add_ref(x, torch.zeros(8), x,
                                                         keep, 0.25)),
        "attention": (lambda: ops.fused_attention(q, q, q, scale=0.5),
                      lambda: ref.attention_ref(q, q, q, None, None, 0.5)[0]),
        "triangle": (lambda: ops.fused_triangle_mult(*tri),
                     lambda: ref.triangle_mult_ref(*tri)[0]),
        "opm": (lambda: ops.fused_outer_product_mean(*opm),
                lambda: ref.outer_product_mean_ref(*opm)),
        # The 4D form (the 5D form on the CPU is the unflattened plain one).
        "softmax": (lambda: ops.fused_softmax(sx4, sb, sm4, sc),
                    lambda: ref.softmax_ref(sx4, sb, sm4, sc)),
    }


LEGS = [("auto", True), ("auto", False), ("oracle", True), ("xla", True),
        ("interpret", True)]


@pytest.mark.parametrize("leg,enabled", LEGS,
                         ids=[f"{l}-{'on' if e else 'off'}" for l, e in LEGS])
@pytest.mark.parametrize("op", ["layer_norm", "elementwise", "attention",
                                "triangle", "opm", "softmax"])
def test_every_leg_runs_the_plain_version_on_cpu(op, leg, enabled,
                                                 monkeypatch):
    monkeypatch.setattr(_build, "entry", lambda name: pytest.fail(name))
    plan = ExecutionPlan(kernels=KernelPolicy(enabled=enabled, **{op: leg}))
    run, plain = _op_calls()[op]
    with use_plan(plan):
        assert ops.kernel_leg(op) == ("oracle" if leg == "auto" and not enabled
                                      else leg)
        torch.testing.assert_close(run(), plain(), rtol=0, atol=0)


@pytest.mark.parametrize("op", ["layer_norm", "elementwise", "attention",
                                "triangle", "opm", "softmax"])
def test_pallas_leg_raises_on_cpu(op):
    run, _ = _op_calls()[op]
    with use_plan(ExecutionPlan(kernels=KernelPolicy(**{op: "pallas"}))):
        with pytest.raises(ValueError, match="'pallas' leg"):
            run()


# (predicate, leg field, reference-envelope args in, out, card-kernel args
# in, out)
PREDICATES = [
    (ops.fused_attention_supported, "attention", ((1, 4, 6, 2, 8),),
     ((1, 4, 6, 2, 300),), ((1, 4, 6, 2, 32),), ((1, 4, 6, 2, 8),)),
    (ops.fused_triangle_supported, "triangle", (16, 16), (2048, 16),
     (128, 128), (16, 16)),
    (ops.fused_opm_supported, "opm", (8, 16), (128, 16), (32, 128), (8, 16)),
]


@pytest.mark.parametrize("pred,op,ref_in,ref_out,card_in,card_out", PREDICATES,
                         ids=["attention", "triangle", "opm"])
def test_envelopes_follow_leg_and_device(pred, op, ref_in, ref_out, card_in,
                                         card_out):
    """On a CPU tensor the reference's envelope; on a CUDA tensor under a
    leg that runs the kernel, the kernel's own; under an oracle leg, never
    fused. No card is needed: the predicates read the device's type."""
    for dev in (None, "cpu"):
        assert pred(*ref_in, device=dev) and not pred(*ref_out, device=dev)
        assert pred(*card_out, device=dev)
    assert pred(*card_in, device="cuda") and not pred(*card_out, device="cuda")
    assert not pred(*ref_in, dtype=torch.float16)
    with use_plan(ExecutionPlan(kernels=KernelPolicy(**{op: "xla"}))):
        assert pred(*card_out, device="cuda")           # the plain version
    with use_plan(ExecutionPlan(kernels=KernelPolicy(**{op: "pallas"}))):
        assert not pred(*card_out, device="cuda")
    for plan in (ExecutionPlan(kernels=KernelPolicy(**{op: "oracle"})),
                 ExecutionPlan(kernels=KernelPolicy(enabled=False))):
        with use_plan(plan):
            assert not pred(*card_in, device="cuda")
            assert not pred(*ref_in, device="cpu")


def _fake_card(monkeypatch):
    """Route as if every tensor lay on the card, with each CUDA wrapper
    replaced by its plain version; returns the calls by kernel."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda t, op: True)
    monkeypatch.setattr(ops, "_is_cuda", lambda device: True)
    fakes = {
        "layer_norm_cuda": lambda x, g, b, eps: ref.layer_norm_ref(x, g, b, eps),
        "bias_sigmoid_mul_cuda": ref.bias_sigmoid_mul_ref,
        "flash_attention_cuda": ref.attention_ref,
        "flash_attention_bwd_cuda": lambda q, k, v, out, do, lse, b, m, s, nd:
            ref.attention_bwd_ref(q, k, v, do, out, lse, b, m, s),
        "fused_triangle_cuda": ref.triangle_mult_ref,
        "fused_opm_cuda": ref.outer_product_mean_ref,
        "bias_dropout_add_cuda": ref.bias_dropout_add_ref,
        "fused_softmax_cuda": ref.softmax_ref,
    }
    for name, fn in fakes.items():
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("bwd", ["auto", "scan"])
def test_attention_backward_keeps_the_forward_leg(bwd, monkeypatch):
    """On a (simulated) card, ``attn_bwd`` as resolved at the forward
    decides the backward, though the backward runs on another thread,
    outside the forward's ``use_plan`` scope."""
    import threading

    calls = _fake_card(monkeypatch)
    scan = []
    real_bwd = ref.attention_bwd_ref
    monkeypatch.setattr(ops.ref, "attention_bwd_ref", lambda *a: (
        scan.append(1), real_bwd(*a))[1])
    q = torch.randn(2, 5, 1, 8, requires_grad=True)
    with use_plan(ExecutionPlan(kernels=KernelPolicy(attn_bwd=bwd))):
        out = ops.fused_attention(q, q, q, bias=torch.randn(1, 1, 5, 5))
    t = threading.Thread(target=lambda: out.sum().backward())
    t.start()
    t.join()
    assert q.grad is not None
    if bwd == "auto":
        assert calls == ["flash_attention_cuda", "flash_attention_bwd_cuda"]
        assert scan == [1]          # inside the stand-in for the kernel
    else:
        assert calls == ["flash_attention_cuda"] and scan == [1]


def test_smoke_widths_take_the_materialized_branches_on_the_card(monkeypatch):
    """SMOKE's widths (head dim 8, triangle C 16, OPM C 8) lie outside the
    attention, triangle and OPM kernels: on a (simulated) card the default
    plan runs K4 at every attention site and none of K5, K7, K8."""
    calls = _fake_card(monkeypatch)
    ff = FastFold(SMOKE, device="cpu")
    batch = next(protein_batches(batch=1, n_seq=3, n_res=6, seed=0)).as_dict()
    out = ff.forward(ff.init(seed=0), batch)
    assert torch.isfinite(out["coords"]).all()
    passes, nb = SMOKE.n_recycle + 1, SMOKE.evoformer.n_blocks
    assert calls.count("fused_softmax_cuda") == 4 * nb * passes
    for k in ("flash_attention_cuda", "fused_triangle_cuda", "fused_opm_cuda"):
        assert k not in calls
    assert calls.count("bias_sigmoid_mul_cuda") == (4 + 2) * nb * passes


KERNEL_OF = {"layer_norm": "layer_norm_cuda",
             "elementwise": "bias_dropout_add_cuda",
             "attention": "flash_attention_cuda",
             "triangle": "fused_triangle_cuda", "opm": "fused_opm_cuda",
             "softmax": "fused_softmax_cuda"}
CARD_LEGS = LEGS + [("pallas", True)]


@pytest.mark.parametrize("leg,enabled", CARD_LEGS,
                         ids=[f"{l}-{'on' if e else 'off'}" for l, e in CARD_LEGS])
@pytest.mark.parametrize("op", list(KERNEL_OF))
def test_every_leg_on_a_simulated_card(op, leg, enabled, monkeypatch):
    """The CUDA column of the leg table, with the CUDA wrappers swapped for
    their plain versions: ``auto`` (kernels enabled) and ``pallas`` reach
    the kernel; ``auto`` with kernels disabled, ``oracle``, ``xla`` and
    ``interpret`` run the plain version, on the same numbers."""
    calls = _fake_card(monkeypatch)
    run, plain = _op_calls()[op]
    with use_plan(ExecutionPlan(kernels=KernelPolicy(enabled=enabled,
                                                     **{op: leg}))):
        got = run()
    kernel = leg == "pallas" or (leg == "auto" and enabled)
    assert calls == ([KERNEL_OF[op]] if kernel else []), calls
    torch.testing.assert_close(got, plain(), rtol=0, atol=0)
