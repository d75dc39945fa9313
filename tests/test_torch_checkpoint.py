"""The port's crash-safe checkpoints (``repro_torch.train.checkpoint``):
the mirror of the reference's checkpoint tests in
``tests/test_resilience.py`` (a save killed mid-write, corrupt files
skipped and removed, a typed restore error), a train state restored bit for
bit into its own dtypes and devices, checkpoints written by either package
restored by the other bit for bit, and the trainer
(``scripts/torch_train_alphafold.py``) killed by a ``checkpoint.save`` fault
and resumed to the state of a run that never stopped."""
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core.alphafold import init_alphafold
from repro.optim.optimizers import OptState as JOptState
from repro.train import checkpoint as jckpt
from repro.train.state import TrainState as JTrainState
from repro_torch.layers.params import tree_leaves
from repro_torch.optim.optimizers import OptState
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.resilience import (CorruptCheckpointError, FaultSpec,
                                    StageTimeout, TransientDecodeFault,
                                    inject_faults)
from repro_torch.train.checkpoint import (latest_checkpoint,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.state import TrainState
from repro_torch.weights import params_from_numpy, randomize_tree

ROOT = Path(__file__).resolve().parents[1]


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(4, dtype=torch.bfloat16)}


def _debris(d):
    return [f for f in os.listdir(d) if f.startswith(".tmp_ckpt_")]


# ---------------------------------------------------------------------------
# Crash safety (tests/test_resilience.py, "Crash-safe checkpointing")
# ---------------------------------------------------------------------------

def test_checkpoint_save_killed_mid_write(tmp_path):
    """A writer crash mid-write (the fault site truncates the temp file
    before the atomic publish) leaves the previous checkpoint restorable
    and only temp debris behind, which the next successful save removes."""
    d = str(tmp_path)
    tree = _tree()
    good = save_checkpoint(d, 0, tree)
    with inject_faults(FaultSpec("timeout", "checkpoint.save")):
        with pytest.raises(StageTimeout):
            save_checkpoint(d, 1, tree)
    assert latest_checkpoint(d) == good
    restored = restore_checkpoint(latest_checkpoint(d), tree)
    assert torch.equal(restored["w"], tree["w"])
    assert _debris(d)
    save_checkpoint(d, 2, tree)
    assert not _debris(d)
    assert latest_checkpoint(d).endswith("ckpt_00000002.npz")


def test_latest_checkpoint_skips_and_gcs_corrupt(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    good = save_checkpoint(d, 0, tree)
    torn = os.path.join(d, "ckpt_00000001.npz")
    data = Path(good).read_bytes()
    Path(torn).write_bytes(data[: len(data) // 2])     # half an npz
    Path(torn + ".json").write_text("{}")
    assert latest_checkpoint(d) == good
    assert not os.path.exists(torn)
    assert not os.path.exists(torn + ".json")
    restore_checkpoint(latest_checkpoint(d), tree)


def test_restore_corrupt_raises_typed(tmp_path):
    bad = tmp_path / "ckpt_00000000.npz"
    bad.write_bytes(b"not an npz at all")
    with pytest.raises(CorruptCheckpointError):
        restore_checkpoint(str(bad), _tree())
    assert latest_checkpoint(str(tmp_path)) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_keep_removes_older_checkpoints(tmp_path):
    for step in range(4):
        save_checkpoint(str(tmp_path), step, _tree(), keep=2)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) == [
        "ckpt_00000002.npz", "ckpt_00000003.npz"]


def test_restore_rejects_a_leaf_of_another_shape(tmp_path):
    path = save_checkpoint(str(tmp_path), 0, _tree())
    with pytest.raises(ValueError, match="'w'"):
        restore_checkpoint(path, {"w": torch.zeros(4, 3),
                                  "b": torch.zeros(4, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# Train states, and the reference's file format
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    init = jax.jit(init_alphafold, static_argnums=1)
    return randomize_tree(
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE)), 17)


def _moments(tree, seed):
    rng = np.random.default_rng(seed)
    m = jax.tree.map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), tree)
    v = jax.tree.map(
        lambda x: np.abs(rng.standard_normal(np.shape(x))).astype(np.float32),
        tree)
    return m, v


def _port_state(tree, m, v, param_dtype, step=5):
    return TrainState(
        torch.tensor(step, dtype=torch.int32),
        params_from_numpy(tree, device="cpu", dtype=param_dtype),
        OptState(torch.tensor(step, dtype=torch.int32),
                 params_from_numpy(m, device="cpu"),
                 params_from_numpy(v, device="cpu")))


def _jax_state(tree, m, v, param_dtype, step=5):
    arr = lambda t, dt=jnp.float32: jax.tree.map(
        lambda x: jnp.asarray(x).astype(dt), t)
    return JTrainState(jnp.asarray(step, jnp.int32), arr(tree, param_dtype),
                       JOptState(jnp.asarray(step, jnp.int32), arr(m), arr(v)))


def _port_flat(state):
    """{key of the file format: numpy array} as the port writes it."""
    return port_ckpt._flatten(state)


def _jax_flat(state):
    """The same as the reference writes it."""
    return jckpt._flatten(state)


def _assert_same_bits(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_train_state_round_trip_keeps_dtypes_devices_and_bits(tree, tmp_path):
    m, v = _moments(tree, 3)
    state = _port_state(tree, m, v, torch.bfloat16)
    path = save_checkpoint(str(tmp_path), 5, state)
    zero = _port_state(jax.tree.map(np.zeros_like, tree),
                       *(jax.tree.map(np.zeros_like, t) for t in (m, v)),
                       torch.bfloat16, step=0)
    back = restore_checkpoint(path, zero)
    assert isinstance(back, TrainState) and isinstance(back.opt_state,
                                                       OptState)
    for got, want in zip(tree_leaves(list(back)), tree_leaves(list(state))):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    assert back.step.dtype == torch.int32 and back.step.device.type == "cpu"
    assert int(back.step) == int(back.opt_state.step) == 5


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages_bit_for_bit(writer, param_dtype, tree,
                                                tmp_path):
    """A train state at step 5 (parameters in ``param_dtype``, fp32
    moments) saved by one package is restored by the other into its own
    state of the same structure; every leaf, both step counters and both
    moments come back bit for bit."""
    m, v = _moments(tree, 4)
    t_dt = getattr(torch, param_dtype)
    j_dt = getattr(jnp, param_dtype)
    port = _port_state(tree, m, v, t_dt)
    ref = _jax_state(tree, m, v, j_dt)
    _assert_same_bits(_port_flat(port), _jax_flat(ref))   # the same state
    zeros = lambda t: jax.tree.map(np.zeros_like, t)
    if writer == "port":
        path = save_checkpoint(str(tmp_path), 5, port)
        back = jckpt.restore_checkpoint(
            path, _jax_state(zeros(tree), zeros(m), zeros(v), j_dt, step=0))
        assert jax.tree.leaves(back.params)[0].dtype == j_dt
        _assert_same_bits(_jax_flat(back), _jax_flat(ref))
    else:
        path = jckpt.save_checkpoint(str(tmp_path), 5, ref)
        back = restore_checkpoint(
            path, _port_state(zeros(tree), zeros(m), zeros(v), t_dt, step=0))
        assert back.params["msa_head"]["w"].dtype == t_dt
        assert back.step.device.type == "cpu"
        _assert_same_bits(_port_flat(back), _port_flat(port))
    assert latest_checkpoint(str(tmp_path)) == path


# ---------------------------------------------------------------------------
# The trainer: killed by a fault, resumed
# ---------------------------------------------------------------------------

def _trainer():
    spec = importlib.util.spec_from_file_location(
        "torch_train_alphafold", ROOT / "scripts" / "torch_train_alphafold.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trainer_resumes_to_the_uninterrupted_state(tmp_path, capsys):
    """SMOKE on the CPU, 4 steps, a checkpoint every 2: a run whose save at
    step 4 is killed by a fault leaves step 2's checkpoint; rerun with the
    same flags, it resumes there and ends bit for bit where a run that
    never stopped ends (the same batches and the same dropout masks)."""
    trainer = _trainer()
    flags = ["--device", "cpu", "--steps", "4", "--ckpt-every", "2",
             "--n-res", "12", "--n-seq", "6", "--batch", "1"]
    whole = trainer.main(flags + ["--ckpt-dir", str(tmp_path / "whole")])
    crashed = str(tmp_path / "crashed")
    with inject_faults(FaultSpec("transient", "checkpoint.save", step=4)):
        with pytest.raises(TransientDecodeFault):
            trainer.main(flags + ["--ckpt-dir", crashed])
    assert latest_checkpoint(crashed).endswith("ckpt_00000002.npz")
    capsys.readouterr()
    resumed = trainer.main(flags + ["--ckpt-dir", crashed])
    assert "at step 2" in capsys.readouterr().out
    assert int(resumed.step) == int(whole.step) == 4
    for got, want in zip(tree_leaves(list(resumed)), tree_leaves(list(whole))):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert latest_checkpoint(crashed).endswith("ckpt_00000004.npz")
