"""The port's device-free dry-run (``repro_torch.launch.dryrun``): FULL
AlphaFold under DAP on a fake process group, whose collectives per block
are ``dap.block_collective_bytes``'s in calls and bytes; a reduced decoder
of each kind (dense, MoE, MLA, hybrid, xLSTM) through ``run_one`` to
``status: ok`` in each mode; a step's gradients and new state held on a
(2, 8) mesh as the plan lays them out; ``long_500k`` skipped for the
reference's reason; the production meshes and the H100's constants; and
no process group left behind, also by a run that fails."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as tdist

from repro_torch.configs import FULL, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dap, dist
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (HBM_BYTES, make_production_mesh,
                                     mesh_of)
from repro_torch.parallel import plan

ROOT = Path(__file__).resolve().parents[1]


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert multi.size == 512 and str(multi) == "2x32x8"
    assert mesh_of((16, 16)).shape == {"data": 16, "model": 16}


def test_full_alphafold_dap_collectives_per_block():
    """The FULL-width fold under DAP over 8 fake ranks (rank 0), one block
    and two: the second block's forward collectives are what
    ``block_collective_bytes`` models, call for call and byte for byte."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.exec import FastFold
    from repro_torch.exec.plan import ExecutionPlan

    b, s, r, n = 1, 128, 256, 8
    plan = ExecutionPlan().with_parallel(backend="gspmd").with_memory(
        hbm_budget=HBM_BYTES)
    logs = []
    with dryrun.fake_group(n):
        for blocks in (1, 2):
            cfg = dataclasses.replace(FULL, evoformer=dataclasses.replace(
                FULL.evoformer, n_blocks=blocks))
            with torch.device("meta"):
                from repro_torch.core.alphafold import init_alphafold
                skeleton = init_alphafold(torch.Generator(), cfg)
            dist.reset_collectives()
            with FakeTensorMode():
                ff = FastFold(cfg, device="cpu", plan=plan)
                ff.forward(dryrun._fake_like(skeleton), dryrun._af_batch(
                    b, s, r), n_recycle=0)
            logs.append(dist.collectives())
    per_block = {k: {key: logs[1][k]["forward"][key]
                     - logs[0][k]["forward"][key] for key in ("calls", "bytes")}
                 for k in ("all_to_all", "all_gather")}
    want = dap.block_collective_bytes(FULL.evoformer, batch=b, n_seq=s,
                                      n_res=r, n=n)
    assert per_block == want
    assert not tdist.is_initialized()


def test_alphafold_initial_training_record():
    """One record of the paper's Initial Training on the production mesh:
    the DAP step's counts, its per-block collectives, memory against the
    card's."""
    rec = dryrun.run_one("alphafold-initial", "train",
                         overrides={"n_blocks": 2})
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 256 and rec["mesh"] == "32x8"
    roof = rec["roofline"]
    for key in ("flops", "hbm_bytes", "wire_bytes", "t_compute_s",
                "t_memory_s", "t_collective_s"):
        assert roof[key] > 0, key
    assert rec["memory"]["hbm_bytes"] == HBM_BYTES
    assert rec["memory"][dryrun.HBM_KEY] is True
    assert rec["counted"]["collectives_per_block"]["counts"]["all-to-all"] > 0
    assert not tdist.is_initialized()


KINDS = {"dense": "qwen2-1.5b", "moe": "deepseek-moe-16b",
         "mla": "deepseek-v2-236b", "hybrid": "hymba-1.5b",
         "xlstm": "xlstm-125m"}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_reduced_decoder_of_each_kind(kind, mode):
    arch = KINDS[kind]
    cfg = get_config(arch, reduced_variant=True)
    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
    shape = ShapeConfig(f"{mode}_64", 64, 64, mode)
    rec = dryrun.run_one(arch, shape.name, overrides=overrides, shape=shape)
    assert rec["status"] == "ok", rec
    roof, mem = rec["roofline"], rec["memory"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert mem["per_device_bytes"] == (mem["state_bytes"]
                                       + mem["activation_bytes"])
    assert mem["activation_bytes"] > 0 and mem[dryrun.HBM_KEY] is True
    assert rec["counted"]["per_device_batch"] == 2


def _by_hand(tree, specs, mesh) -> float:
    """Each device's bytes of ``tree`` under ``specs``: every leaf's bytes
    over the shards its spec names."""
    return sum(t.numel() * t.element_size() / dryrun._shards(s, mesh)
               for t, s in zip(plan._leaves(tree), plan._spec_leaves(specs)))


@pytest.mark.parametrize("arch", ["alphafold-initial", "qwen2-1.5b"])
def test_step_copies_held_as_the_plan_lays_them_out(arch):
    """On a (2, 8) mesh a step's gradients, as its backward ends, and its
    new state, at its end, are held as the plan lays out what they stand
    for: the gradients and new parameters by the parameters' own specs
    (whole where the plan replicates them, as DAP does AlphaFold's), the
    new moments by the m/v specs. The slack is the step's scalars (the
    loss, its metrics, the step count)."""
    from repro_torch.models.decoder import init_model
    from repro_torch.train.loop import make_train_step

    mesh = mesh_of((2, 8))
    init_state, _ = make_train_step(lambda *a: None)
    if arch == "alphafold-initial":
        from repro_torch.core.alphafold import init_alphafold

        rec = dryrun.run_one(arch, "train", overrides={"n_blocks": 1},
                             mesh=mesh)
        cfg = dataclasses.replace(FULL, evoformer=dataclasses.replace(
            FULL.evoformer, n_blocks=1))
        with torch.device("meta"):
            state = init_state(init_alphafold(torch.Generator(), cfg))
        p_specs = plan.tree_replicated(state.params)
    else:
        shape = ShapeConfig("train_64", 64, 4, "train")
        rec = dryrun.run_one(arch, shape.name, shape=shape, mesh=mesh)
        with torch.device("meta"):
            state = init_state(init_model(None, get_config(arch)))
        p_specs = plan.model_param_specs(state.params, mesh)
    assert rec["status"] == "ok", rec
    specs = plan.train_state_specs(state, mesh, p_specs)
    grads = _by_hand(state.params, specs.params, mesh)
    new_state = grads + sum(_by_hand(t, s, mesh) for t, s in (
        (state.opt_state.m, specs.opt_state.m),
        (state.opt_state.v, specs.opt_state.v)))
    whole = plan.params_fp32_bytes(state.params)
    if arch == "alphafold-initial":
        assert grads == whole
    else:
        assert grads < whole / 2          # the plan shards the decoder's
    counted, mem = rec["counted"], rec["memory"]
    assert 0 <= counted["gradient_bytes"] - grads <= 64
    assert 0 <= counted["output_bytes"] - new_state <= 64
    assert mem["activation_bytes"] >= max(counted["gradient_bytes"],
                                          counted["output_bytes"])


def test_one_device_step_is_the_program_itself():
    """On a 1 x 1 mesh nothing is sharded: the FLOPs are the whole step's,
    and no collective is implied."""
    cfg = get_config("qwen2-1.5b", reduced_variant=True)
    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
    shape = ShapeConfig("train_64", 64, 2, "train")
    rec = dryrun.run_one("qwen2-1.5b", shape.name, overrides=overrides,
                         shape=shape, mesh=mesh_of((1, 1)))
    assert rec["collectives"]["wire_bytes"] == 0
    assert rec["counted"]["sequence_shards"] == 1
    assert rec["roofline"]["flops"] >= rec["counted"][
        "model_flops_per_device"]


def test_long_500k_skipped_for_the_reference_reason():
    rec = dryrun.run_one("qwen2-1.5b", "long_500k")
    assert rec["status"] == "skipped"
    # The reference's module forces 512 host devices when imported, so its
    # reason is read from its source.
    ref_src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    words = rec["reason"].split()
    assert " ".join(words[:6]) in ref_src and words[-1] in ref_src
    assert dryrun.skip_reason(get_config("xlstm-125m"),
                              dryrun.INPUT_SHAPES["long_500k"]) is None


def test_fake_group_is_destroyed_when_the_run_fails(monkeypatch):
    with pytest.raises(ZeroDivisionError):
        with dryrun.fake_group(4):
            assert tdist.get_world_size() == 4
            1 / 0
    assert not tdist.is_initialized()

    def broken(*a, **kw):
        assert tdist.is_initialized()
        raise RuntimeError("a run that fails inside its group")

    monkeypatch.setattr(dryrun, "_counted", broken)
    with pytest.raises(RuntimeError, match="fails inside its group"):
        dryrun.run_one("alphafold-initial", "train")
    assert not tdist.is_initialized()


def test_cli_writes_records(tmp_path):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                 "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok"]
    assert set(recs[0]["roofline"]) >= {"t_compute_s", "t_memory_s",
                                        "t_collective_s", "bottleneck"}


def test_importing_initialises_no_group_and_touches_no_device():
    code = ("import torch, torch.distributed as d\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.parallel.plan, repro_torch.roofline.analysis\n"
            "assert not d.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})


def test_no_tpu_constant_in_the_port():
    """The reference's TPU v5e constants (197 TFLOP/s, 819 GB/s, 16 GB)
    appear nowhere in the port."""
    for path in (ROOT / "src/repro_torch").rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "16 << 30", "fits_16GB"):
            assert const not in text, (path, const)
