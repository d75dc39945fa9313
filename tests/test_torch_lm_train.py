"""Decoder LM training in the port against the JAX package, the dense and
attention kinds: ``lm_loss`` (its ``loss``, ``ce``, ``aux`` and ``ppl``)
and every gradient leaf of the reduced qwen2-1.5b, yi-9b, qwen1.5-32b,
gemma3-27b (sliding window and qk-norm), llava-next-mistral-7b (a prefix of
patch embeddings, dropped from the loss) and musicgen-medium (LayerNorm,
the port's K1 op taking its plain version on the CPU), on the same fully
randomised weights and batch, through ``jax.value_and_grad`` of the
reference's ``lm_loss`` (its ``model_forward`` at the compute dtype under
test). Tolerances (torch_parity): fp32 1e-3·max(1, max|jax|) for the
whole model, bf16 2e-2. Then: the per-layer checkpoint (``remat``)
changes no bit (``torch_parity.assert_remat_changes_no_bit``); the
reference's ``test_smoke_forward_and_train_step`` and
``test_lm_training_loss_decreases`` on the port; three optimizer steps
against the reference's, also the trainer's at full width cut to 2
layers; and the trainer CLI with ``--trace`` and
``--ckpt-dir`` (the checkpoint restored by both packages). The MoE, MLA,
hymba and xLSTM kinds are in ``test_torch_lm_train_kinds.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models import decoder as jdec
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro_torch.configs import get_config as tget
from repro_torch.data import lm_batches as t_lm_batches
from repro_torch.launch import train as ttrain
from repro_torch.layers.params import tree_map
from repro_torch.models import decoder as tdec
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.events import read_jsonl
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.weights import decoder_params_to_numpy
from torch_parity import (FORWARD_TOL, MODULE_TOL, assert_close,
                          assert_lm_loss_close,
                          assert_remat_changes_no_bit,
                          assert_smoke_forward_and_train_step,
                          decoder_weights, lm_batch_both, lm_loss_both,
                          np_tree, reference_compute_dtype,
                          one_torch_thread)  # noqa: F401

DT = ["float32", "bfloat16"]
DENSE = ["qwen2-1.5b", "yi-9b", "qwen1.5-32b", "gemma3-27b",
         "llava-next-mistral-7b", "musicgen-medium"]
TOL = {"float32": FORWARD_TOL["float32"], "bfloat16": MODULE_TOL["bfloat16"]}
# 32 tokens: past gemma3's reduced window (16), a multiple of nothing the
# blocks need (one key block of 1024, one query block).
B, S = 2, 32


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_grads_match_the_reference(arch, dtype):
    jc, tc = jget(arch, reduced_variant=True), tget(arch, reduced_variant=True)
    jp, tp = decoder_weights(jdec, jc, 0)
    jb, tb = lm_batch_both(jc, B, S, seed=3)
    port, ref = lm_loss_both(jdec, tdec, jc, tc, jp, tp, jb, tb, dtype)
    assert_lm_loss_close(port, ref, TOL[dtype], f"{arch} {dtype}")
    assert float(port[1]["aux"]) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_with_several_key_blocks(arch):
    """The model with ``attn_kv_block`` 8 (four key blocks at 32 tokens;
    gemma3's full-attention layer, llava's 40 with its prefix), fp32."""
    import dataclasses

    jc = dataclasses.replace(jget(arch, reduced_variant=True),
                             attn_kv_block=8)
    tc = dataclasses.replace(tget(arch, reduced_variant=True),
                             attn_kv_block=8)
    jp, tp = decoder_weights(jdec, jc, 1)
    jb, tb = lm_batch_both(jc, B, S, seed=4)
    port, ref = lm_loss_both(jdec, tdec, jc, tc, jp, tp, jb, tb, "float32")
    assert_lm_loss_close(port, ref, TOL["float32"], f"{arch} kv_block 8")


@pytest.mark.parametrize("arch", DENSE)
def test_remat_changes_no_bit(arch):
    assert_remat_changes_no_bit(jdec, tdec, arch)


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_and_train_step(arch):
    assert_smoke_forward_and_train_step(tdec, arch)


def test_lm_training_loss_decreases():
    """The port's counterpart of the reference's
    ``test_system.py::test_lm_training_loss_decreases``: 25 steps of
    ``make_train_step`` over ``lm_loss`` on reduced qwen2-1.5b."""
    cfg = tget("qwen2-1.5b", reduced_variant=True)
    params = tdec.init_model(torch.Generator().manual_seed(0), cfg)
    gen = t_lm_batches(vocab=cfg.vocab, batch=4, seq=32, seed=0)
    init_state, train_step = tloop.make_train_step(
        lambda p, b, r: tdec.lm_loss(p, b, cfg),
        base_lr=3e-3, warmup_steps=5, total_steps=500)
    state = init_state(params)
    losses = []
    for _ in range(25):
        state, metrics = train_step(state, ttrain.lm_batch(next(gen), cfg,
                                                           "cpu"))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def _steps_both(jc, tc, seed: int, steps: int, batch: int, seq: int, **kw):
    """``steps`` steps of ``make_train_step`` over ``lm_loss`` in both
    packages (fp32 compute, the reference's ``model_forward`` at fp32 too)
    from the same randomised weights on the same ``lm_batches`` (and the
    reference trainer's zero bf16 prefix), each step's loss, gradient
    norm, learning rate and skips held at 1e-3. Returns (port state,
    reference state, the port's losses)."""
    jp, tp = decoder_weights(jdec, jc, seed)
    j_init, j_step = jloop.make_train_step(
        lambda p, b, r: jdec.lm_loss(p, b, jc), **kw)
    t_init, t_step = tloop.make_train_step(
        lambda p, b, r: tdec.lm_loss(p, b, tc, compute_dtype=torch.float32),
        **kw)
    js, ts = j_init(jp), t_init(tp)
    gj = j_lm_batches(vocab=jc.vocab, batch=batch, seq=seq, seed=0)
    gt = t_lm_batches(vocab=tc.vocab, batch=batch, seq=seq, seed=0)
    tol = FORWARD_TOL["float32"]
    losses = []
    with reference_compute_dtype(jdec, jnp.float32):
        step = jax.jit(j_step)
        for i in range(steps):
            lb = next(gj)
            jb = {"tokens": jnp.asarray(lb.tokens),
                  "targets": jnp.asarray(lb.targets),
                  "mask": jnp.asarray(lb.mask)}
            if jc.modality and jc.modality.n_prefix_tokens:
                jb["prefix_embeds"] = jnp.zeros(
                    (batch, jc.modality.n_prefix_tokens, jc.d_model),
                    jnp.bfloat16)
            js, jm = step(js, jb, None)
            ts, tm = t_step(ts, ttrain.lm_batch(next(gt), tc, "cpu"))
            for k in ("loss", "grad_norm", "lr", "nonfinite_skips"):
                assert_close(tm[k], jm[k], tol, f"step {i} {k}")
            losses.append(float(tm["loss"]))
    return ts, js, losses


def test_three_steps_track_the_reference():
    """Three AdamW steps of ``make_train_step`` over ``lm_loss`` (fp32
    compute, the reference's ``model_forward`` at fp32 too) from the same
    randomised musicgen-medium weights on the same ``lm_batches`` (and
    the zero prefix of its 8 reduced audio frames): the
    loss, gradient norm and learning rate of every step, and every
    parameter and moment after the last, at 1e-3."""
    jc = jget("musicgen-medium", reduced_variant=True)
    tc = tget("musicgen-medium", reduced_variant=True)
    ts, js, _ = _steps_both(jc, tc, 3, steps=3, batch=2, seq=16,
                            base_lr=1e-3, warmup_steps=1, total_steps=10)
    tol = FORWARD_TOL["float32"]
    for name, port, ref in (("params", ts.params, js.params),
                            ("m", ts.opt_state.m, js.opt_state.m),
                            ("v", ts.opt_state.v, js.opt_state.v)):
        for g, w in zip(jax.tree.leaves(decoder_params_to_numpy(port)),
                        jax.tree.leaves(np_tree(ref))):
            assert_close(g, w, tol, name)


def test_full_width_steps_track_the_reference():
    """The trainer's three steps (``launch.train``'s schedule: 3e-4,
    warm-up 5, cosine to 3) on musicgen-medium at full width cut to 2
    layers, every leaf random, fp32: each step's loss, gradient norm and
    learning rate equal the reference's at 1e-3. The reduced configs
    above do not show a step at the published widths; this one does, so a
    loss that rises after the first updates of a full-width model of
    random weights (as on the card) is the reference's behaviour too."""
    import dataclasses

    jc = dataclasses.replace(jget("musicgen-medium"), n_layers=2)
    tc = dataclasses.replace(tget("musicgen-medium"), n_layers=2)
    _, _, losses = _steps_both(jc, tc, 5, steps=3, batch=2, seq=128,
                               base_lr=3e-4, warmup_steps=5, total_steps=3)
    assert np.isfinite(losses).all(), losses


def test_trainer_cli(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu --steps
    3 --trace ... --ckpt-dir ...``: three steps, one ``train_step`` event
    each with its tokens and the step's six spans, a trace ``python -m
    repro_torch.obs report --strict`` accepts, and a checkpoint that the
    port restores bit for bit and the reference restores into its own
    train state (the same keys and shapes, the decoder's stages under
    ``[i]``)."""
    trace, ckdir = tmp_path / "ev.jsonl", tmp_path / "ck"
    ttrain.main(["--arch", "llava-next-mistral-7b", "--reduced", "--device",
                 "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                 "--trace", str(trace), "--ckpt-dir", str(ckdir)])
    out = capsys.readouterr().out
    # Each step: its train_step event and the step's six spans.
    assert "3 steps in" in out and "(21 events)" in out
    events = [e for e in read_jsonl(str(trace)) if e["kind"] == "train_step"]
    assert len(events) == 3 and all(e["tokens"] == 32 for e in events)
    spans = [e["name"] for e in read_jsonl(str(trace)) if e["kind"] == "span"]
    assert sorted(spans) == sorted(3 * ["train.step", "train.forward",
                                        "train.backward", "train.clip",
                                        "train.optimizer", "train.wait"])
    assert obs_main(["report", str(trace), "--strict"]) == 0
    path = tckpt.latest_checkpoint(str(ckdir))
    assert path.endswith("ckpt_00000003.npz")

    cfg = tget("llava-next-mistral-7b", reduced_variant=True)
    init, _ = ttrain.make_lm_step(cfg, steps=3, batch=2, seq=16)
    example = init(tdec.init_model(torch.Generator().manual_seed(1), cfg))
    state = tckpt.restore_checkpoint(path, example)
    saved = np.load(path)
    flat = tckpt._flatten(state)
    assert set(flat) == set(saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(flat[k], saved[k])
    assert int(state.step) == 3

    jc = jget("llava-next-mistral-7b", reduced_variant=True)
    j_init, _ = jloop.make_train_step(lambda p, b, r: jdec.lm_loss(p, b, jc))
    jstate = jckpt.restore_checkpoint(
        path, j_init(jdec.init_model(jax.random.PRNGKey(0), jc)))
    for g, w in zip(jax.tree.leaves(decoder_params_to_numpy(state.params)),
                    jax.tree.leaves(np_tree(jstate.params))):
        np.testing.assert_array_equal(g, w)


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    """Without ``--device`` the trainer asks for the card, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttrain.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"])


def test_lm_batch_prefix_is_zero_bf16():
    """A modality configuration's batch carries zero bf16
    ``prefix_embeds`` (B, P, d), as the reference's trainer makes them;
    tokens and targets are int64 copies of ``lm_batches``'."""
    cfg = tget("llava-next-mistral-7b", reduced_variant=True)
    lb = next(t_lm_batches(vocab=cfg.vocab, batch=3, seq=8, seed=1))
    batch = ttrain.lm_batch(lb, cfg, "cpu")
    pe = batch["prefix_embeds"]
    assert pe.dtype == torch.bfloat16 and pe.shape == (3, 8, cfg.d_model)
    assert not pe.any()
    assert batch["tokens"].dtype == torch.long
    np.testing.assert_array_equal(batch["targets"].numpy(), lb.targets)
    assert "prefix_embeds" not in ttrain.lm_batch(
        lb, tget("qwen2-1.5b", reduced_variant=True), "cpu")


@pytest.mark.parametrize("remat,per_layer", [(True, 4), (False, 2)])
def test_layer_norm_calls_a_training_step(monkeypatch, remat, per_layer):
    """The LayerNorm op (K1 on the card) runs 2 · n_layers + 1 times in
    musicgen-medium's forward and, under ``remat``, 2 · n_layers more in
    the backward's recompute (the final norm lies outside the
    checkpoints); its backward is plain. Counted on the CPU, where the op
    takes its plain version through the same call."""
    from repro_torch.kernels import ops

    calls = []
    orig = ops._ln_fwd
    monkeypatch.setattr(ops, "_ln_fwd",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    cfg = tget("musicgen-medium", reduced_variant=True)
    params = tdec.init_model(torch.Generator().manual_seed(0), cfg)
    live = tree_map(lambda t: t.requires_grad_(True), params)
    _, tb = lm_batch_both(cfg, B, S, seed=7)
    loss, _ = tdec.lm_loss(live, tb, cfg, remat=remat)
    loss.backward()
    assert len(calls) == per_layer * cfg.n_layers + 1
