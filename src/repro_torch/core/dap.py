"""Dynamic Axial Parallelism entry points (paper §IV.B): the port's counterpart
of the reference's ``core/dap.py``.

``dap_evoformer_stack(group, cfg)`` runs the Evoformer stack, written once
against the ``dist`` interface, with explicit collectives on a
``torch.distributed`` process group: the paper-faithful path. Parameters
are replicated (DAP's defining property: whole parameters on every rank,
sharded activations); the activations follow the shard layout of
``dap_specs``:

  msa       (B, s, r, Hm)  sharded on dim 1 (s)
  pair      (B, r, r, Hz)  sharded on dim 1 (i)
  msa_mask  (B, s, r)      sharded on dim 1, like the MSA
  pair_mask (B, r, r)      sharded on dim 1, like the pair
  seq_mask  (B, r)         whole on every rank

``shard_dap_inputs`` takes each rank's slices of whole tensors and
``unshard`` gathers shards back. ``whole_model_evoformer`` is the stack of
a model that holds whole tensors on every rank (``core.dist.WholeModelDist``,
the reference's ``GspmdDist`` role): it scatters the stack's inputs at
entry and gathers its outputs at exit.
"""
from __future__ import annotations

from repro_torch.configs.alphafold import EvoformerConfig
from repro_torch.core.dist import ProcessGroupDist
from repro_torch.core.evoformer import evoformer_stack

def dap_specs() -> dict:
    """The shard layout: each Evoformer input's dim that rides the DAP
    group (None: whole on every rank)."""
    return {"msa": 1, "pair": 1, "msa_mask": 1, "seq_mask": None,
            "pair_mask": 1}


def shard_dap_inputs(group, msa, pair, msa_mask, seq_mask, pair_mask):
    """Each rank's slices of whole tensors, in ``dap_specs``'s layout
    (``group=None``: the default group). A group size that does not divide
    s or r raises ValueError naming the sizes."""
    d = ProcessGroupDist(group)
    d.check_layout(n_seq=msa.shape[1], n_res=msa.shape[2])
    xs = (msa, pair, msa_mask, seq_mask, pair_mask)
    return tuple(x if axis is None else d.shard(x, axis=axis)
                 for x, axis in zip(xs, dap_specs().values()))


def unshard(group, *xs, axis: int = 1):
    """The whole tensors of shards on ``axis`` (an all-gather whose
    backward is the rank's slice)."""
    d = ProcessGroupDist(group)
    return tuple(d.gather(x, axis=axis) for x in xs)


def dap_evoformer_stack(group, cfg: EvoformerConfig, *, train: bool = False,
                        remat: bool = True):
    """``fn(params, msa, pair, msa_mask, seq_mask, pair_mask, keeps=None) ->
    (msa, pair)`` running the Evoformer stack under DAP on ``group``, on
    and into shards in ``dap_specs``'s layout. ``keeps`` (used with
    ``train=True``): the dropout masks drawn whole; each rank takes its
    shards. ``remat`` checkpoints each block where a graph is built."""
    d = ProcessGroupDist(group)

    def fn(params, msa, pair, msa_mask, seq_mask, pair_mask, keeps=None):
        return evoformer_stack(params, msa, pair, msa_mask, seq_mask,
                               pair_mask, cfg=cfg,
                               keeps=keeps if train else None, remat=remat,
                               dist=d)

    return fn


def whole_model_evoformer(params, msa, pair, msa_mask, seq_mask, pair_mask,
                          *, cfg: EvoformerConfig, dist, keeps=None,
                          remat: bool = False):
    """The Evoformer stack on whole tensors held by every rank: each takes
    its shards (``dist.scatter``: the backward all-gathers the gradient),
    runs the stack under DAP, and gathers the outputs (``dist.gather``: the
    backward is the rank's slice of a gradient every rank holds whole). A
    group size that does not divide s or r raises ValueError."""
    dist.check_layout(n_seq=msa.shape[1], n_res=msa.shape[2])
    m, z = evoformer_stack(
        params, dist.scatter(msa, axis=1), dist.scatter(pair, axis=1),
        dist.shard(msa_mask, axis=1), seq_mask,
        dist.shard(pair_mask, axis=1), cfg=cfg, keeps=keeps, remat=remat,
        dist=dist)
    return dist.gather(m, axis=1), dist.gather(z, axis=1)


def block_collective_bytes(cfg: EvoformerConfig, *, batch: int, n_seq: int,
                           n_res: int, n: int, dtype_bytes: int = 2,
                           mask_bytes: int = 4) -> dict[str, dict]:
    """Each rank's collectives in one Evoformer block's forward under DAP
    over ``n`` ranks, computed from the shapes as ``core.dist.COLLECTIVES``
    counts them: {kind: {"calls", "bytes"}}, the bytes a rank sends to the
    others (an all-to-all (n - 1)/n of its input, an all-gather n - 1 times
    its shard). The paper's Table III accounting: 8 all-to-alls (the MSA
    there and back, its mask, and the pair, its mask and two updates
    transposed) and 7 all-gathers (three pair biases, the outer-product
    mean's right projection and mask, and two triangle updates' b)."""
    b, s, r = batch, n_seq, n_res
    s_l, r_l = s // n, r // n
    msa_l = b * s_l * r * cfg.d_msa * dtype_bytes      # s shard = r shard
    pair_l = b * r_l * r * cfg.d_pair * dtype_bytes
    a2a = [msa_l, b * s_l * r * mask_bytes, msa_l,
           pair_l, b * r_l * r * mask_bytes, pair_l, pair_l, pair_l]
    ag = [b * cfg.msa_heads * r_l * r * dtype_bytes,
          b * s * r_l * cfg.opm_dim * dtype_bytes,
          b * s * r_l * mask_bytes,
          b * r_l * r * cfg.tri_mult_dim * dtype_bytes,
          b * r_l * r * cfg.tri_mult_dim * dtype_bytes,
          b * cfg.pair_heads * r_l * r * dtype_bytes,
          b * cfg.pair_heads * r_l * r * dtype_bytes]
    return {"all_to_all": {"calls": len(a2a),
                           "bytes": sum(x * (n - 1) // n for x in a2a)},
            "all_gather": {"calls": len(ag),
                           "bytes": sum(x * (n - 1) for x in ag)}}
