"""The benchmark's plain fp32 reference agrees with the port's plain path
at SMOKE widths (2 blocks, r = 16, s = 8, fp32, on the CPU): the fold's
outputs, the training loss and every gradient, with and without dropout;
the structure module's stage alone; its parameter tree is the port's; and its counted model FLOPs equal
``repro_torch.roofline.analysis.counting()``'s on the same cut."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench.harness.program import port_config, to_device
from portbench.harness.weights import draw_weights
from portbench.reference.alphafold import (AlphaFold, Dims, alphafold_loss,
                                           draw_dropout_keeps, leaves,
                                           param_shapes, rebuild)
from portbench.reference.costs import count_flops
from portbench.reference.synthetic import protein_batch
from portbench.tests.tiny import BENCH, TINY

import json

CONFIG = {**json.loads((BENCH / "configs" / "alphafold-full.json")
                       .read_text()), **TINY}
DIMS = Dims.from_config(CONFIG)


def _batch(seed=3, n_real=13):
    b = protein_batch(rng=np.random.default_rng(seed), batch=1, n_seq=8,
                      n_res=16, n_real=n_real)
    return to_device(b, "cpu")


def _port():
    from repro_torch.exec import FastFold

    return FastFold(port_config(CONFIG), device="cpu")


def test_parameter_tree_is_the_ports():
    from repro_torch.core.alphafold import init_alphafold

    port = init_alphafold(torch.Generator().manual_seed(0),
                          port_config(CONFIG))
    ours = param_shapes(DIMS)
    got = [(p, tuple(t.shape)) for p, t in leaves(port)]
    assert got == [(p, tuple(s)) for p, s in leaves(ours)]


def test_fold_outputs_agree():
    params = draw_weights(param_shapes(DIMS), 11, "cpu")
    batch = _batch()
    want = AlphaFold(DIMS).forward(params, batch)
    got = _port().forward(params, batch)
    for key in ("coords", "distogram_logits", "msa_logits"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-4)


def test_structure_stage_is_the_folds_structure_module():
    """The structure module run alone on a padded fold's own Evoformer
    outputs, sliced to the real residues, gives the fold's coordinates:
    padded residues are masked keys and change no real residue."""
    params = draw_weights(param_shapes(DIMS), 12, "cpu")
    batch = _batch(n_real=11)
    model = AlphaFold(DIMS)
    out = model.forward(params, batch)
    stage = model.structure_stage(params, out["msa"][0, 0, :11],
                                  out["pair"][0, :11, :11])
    torch.testing.assert_close(stage, out["coords"][0, :11], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dropout", [False, True])
def test_loss_and_gradients_agree(dropout):
    params = draw_weights(param_shapes(DIMS), 12, "cpu")
    batch = _batch(seed=5)
    paths = [p for p, _ in leaves(params)]

    def grads(loss_of):
        live = [t.detach().clone().requires_grad_(True)
                for _, t in leaves(params)]
        loss = loss_of(rebuild(params, live))
        g = torch.autograd.grad(loss, live, allow_unused=True)
        return float(loss.detach()), [torch.zeros_like(t) if x is None else x
                             for x, t in zip(g, live)]

    gen = lambda: torch.Generator().manual_seed(99) if dropout else None  # noqa: E731
    ff = _port()
    lp, gp = grads(lambda p: ff.train_loss(p, batch, gen())[0])

    def ref_loss(p):
        keeps = (draw_dropout_keeps(DIMS, tuple(batch["msa"].shape), gen())
                 if dropout else None)
        out = AlphaFold(DIMS).forward(p, batch, keeps=keeps, train=True,
                                      remat=True)
        return alphafold_loss(out, batch)

    lr, gr = grads(ref_loss)
    assert math.isclose(lp, lr, rel_tol=1e-5)
    for path, a, b in zip(paths, gp, gr):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6,
                                   msg=lambda m: f"{path}: {m}")


def test_model_flops_equal_the_ports_count():
    from repro_torch.roofline.analysis import counting

    params = draw_weights(param_shapes(DIMS), 13, "cpu")
    batch = _batch()
    flops, _ = count_flops(AlphaFold(DIMS).forward, params, batch)
    with counting() as c:
        _port().forward(params, batch)
    assert flops == pytest.approx(c.flops, rel=0.01)
    # Two more blocks add what the first two do, as the harness's
    # extrapolation assumes.
    deeper = dataclasses.replace(DIMS, n_blocks=4)
    f4, _ = count_flops(AlphaFold(deeper).forward,
                        draw_weights(param_shapes(deeper), 13, "cpu"), batch)
    one = dataclasses.replace(DIMS, n_blocks=1)
    f1, _ = count_flops(AlphaFold(one).forward,
                        draw_weights(param_shapes(one), 13, "cpu"), batch)
    assert f4 == pytest.approx(f1 + 3 * (flops - f1), rel=1e-9)
