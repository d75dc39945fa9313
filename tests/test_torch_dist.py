"""The port's process-group backend (``repro_torch.core.dist``) and Duality
Async pair (``repro_torch.core.duality``) on gloo groups of 2 and 4 spawned
CPU processes: each collective and its autograd dual against the result of
one process on the gathered tensors, forward and gradient (fp32, exact up to
the order of a sum of N terms); trigger/block equal to the synchronous
collective, bit for bit, with the windows open and closed; the event log of
one DAP Evoformer block showing the MSA swap-back's window holding the pair
stack in the forward and in the backward; and the counts of bytes each rank
sends. One spawn per group size serves the whole module."""
import numpy as np
import pytest
import torch

from repro_torch.core import dist as D
from repro_torch.core import duality
import torch_dist_cases as cases

SIZES = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    """{N: [rank results]}, each result (collective cases, duality cases)."""
    return {n: D.run_ranks(cases.dist_cases, n, timeout_s=240)
            for n in SIZES}


def _shard(x, axis, r, n):
    size = x.shape[axis] // n
    return np.take(x, range(r * size, (r + 1) * size), axis=axis)


def _expected(name, n):
    """Per rank (out, grad) of the single-process computation on the
    gathered tensors."""
    x, w, y = cases.collective_inputs(n)
    out = []
    for r in range(n):
        if name == "all_to_all":
            # A permutation of the elements: out is x's r-th shard on axis
            # 2, and the gradient w's shard in x's layout.
            out.append((_shard(x, 2, r, n), _shard(w[0], 1, r, n)))
        elif name == "all_gather":
            out.append((x, _shard(w.sum(0), 1, r, n)))
        elif name == "psum_scatter":
            out.append((_shard(y.sum(0), 1, r, n), w[0]))
        elif name == "scatter":
            out.append((_shard(x, 1, r, n), w[0]))
        elif name == "gather":
            out.append((x, _shard(w[0], 1, r, n)))
        elif name == "all_reduce":
            out.append((y.sum(0), w[0]))
        elif name in ("copy_to_ranks", "sync_grads"):
            out.append((x, w.sum(0)))
    return out


COLLECTIVES = ("all_to_all", "all_gather", "psum_scatter", "scatter",
               "gather", "all_reduce", "copy_to_ranks", "sync_grads")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_and_its_dual(name, n, ranks):
    for r, ((res, _), (want_out, want_grad)) in enumerate(
            zip(ranks[n], _expected(name, n))):
        out, grad = res[name]
        np.testing.assert_allclose(out, want_out, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} rank {r} forward")
        np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} rank {r} gradient")


@pytest.mark.parametrize("n", SIZES)
def test_bytes_each_rank_sends(n, ranks):
    """An all-to-all sends (N-1)/N of its input, an all-gather N-1 times
    its shard, an all-reduce 2 (N-1)/N of its tensor (fp32)."""
    x = np.zeros(cases.SHAPE, np.float32)
    full, shard = x.nbytes, x.nbytes // n
    counts = ranks[n][0][0]["collectives"]
    # Forward: all_to_all, all_gather, gather's exit all-gather.
    assert counts["all_to_all"]["forward"] == {
        "calls": 1, "bytes": shard * (n - 1) // n}
    assert counts["all_gather"]["forward"] == {
        "calls": 1, "bytes": shard * (n - 1)}
    assert counts["all_gather"]["stack exit"] == {
        "calls": 1, "bytes": shard * (n - 1)}
    # all_reduce forward (g), copy_to_ranks and sync_grads backward (f).
    assert counts["all_reduce"]["forward"] == {
        "calls": 1, "bytes": 2 * full * (n - 1) // n}
    assert counts["all_reduce"]["backward"]["calls"] == 2


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["all_gather", "all_to_all"])
def test_trigger_block_equals_the_synchronous_collective(kind, n, ranks):
    for r, (_, dual) in enumerate(ranks[n]):
        sync = dual[f"{kind} sync"]
        for how in ("open", "closed"):
            for got, want in zip(dual[f"{kind} {how}"], sync):
                assert np.array_equal(got, want), (kind, how, r)


@pytest.mark.parametrize("n", SIZES)
def test_msa_swap_back_window_holds_the_pair_stack(n, ranks):
    """In one checkpointed DAP block, forward and backward, the window of
    the MSA swap-back all-to-all (the only windowed all-to-all) holds every
    site of the pair stack; the gathers' windows hold their left
    operands."""
    pair_stack = {"tri_mult_out", "tri_mult_in", "tri_attn_start",
                  "tri_attn_end", "pair_trans"}
    for r, (_, dual) in enumerate(ranks[n]):
        rep = duality.overlap_report(dual["block_log"])
        swaps = [w for w in rep["windows"] if w["collective"] == "all_to_all"]
        passes = {w["pass"] for w in swaps}
        assert passes == {"forward", "backward"}, (r, swaps)
        for w in swaps:
            labels = {lab for lab, p in w["compute"] if p == w["pass"]}
            assert pair_stack <= labels, (r, w["pass"], labels)
        gathers = [w for w in rep["windows"] if w["collective"] == "all_gather"]
        # Three biases, the OPM's b and two triangle b's: 6 forward windows
        # (the recompute launches them again), each holding compute.
        fwd = [w for w in gathers if w["pass"] == "forward"]
        assert len(fwd) % 6 == 0 and fwd, (r, len(fwd))
        assert all(w["compute"] for w in gathers), r
        assert rep["pairs_with_compute_between"] == rep["pairs"]


def test_layout_the_group_cannot_take_raises():
    with pytest.raises(ValueError, match="n_res=6"):
        D.check_layout(4, n_seq=8, n_res=6)
    D.check_layout(2, n_seq=8, n_res=6)


def test_backend_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        D.ProcessGroupDist()


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank one fails"):
        D.run_ranks(cases.fails_on_rank_one, 2, timeout_s=120)


def test_a_hung_collective_fails_the_run_within_its_timeout():
    with pytest.raises(RuntimeError, match="still running after 8 s"):
        D.run_ranks(cases.hangs_in_a_collective, 2, timeout_s=8)


def test_a_rank_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(backend="nccl"), dict(backend="gloo", device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.form_group(0, 1, str(tmp_path / "store"), **kw)
