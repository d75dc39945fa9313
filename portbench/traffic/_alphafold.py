"""What both AlphaFold traffic kinds share: the reference model of the
cell's configuration and the work of one item, counted on ``meta``
tensors."""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from portbench.reference.alphafold import (DROPOUT_SITES, AlphaFold, Dims,
                                           Sites, alphafold_loss, leaves,
                                           param_shapes, rebuild)
from portbench.reference.costs import count_flops

ROW_BYTES = 1 << 30


def meta_batch(b: int, s: int, r: int) -> dict:
    m = lambda *shape, dt=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dt, device="meta")
    return {"msa": m(b, s, r, dt=torch.int32), "msa_mask": m(b, s, r),
            "residue_index": m(b, r, dt=torch.int32),
            "aatype": m(b, r, dt=torch.int32), "seq_mask": m(b, r),
            "pseudo_beta": m(b, r, 3), "bert_mask": m(b, s, r),
            "true_msa": m(b, s, r, dt=torch.int32)}


def item_work(dims: Dims, b: int, s: int, r: int, train: bool):
    """(model FLOPs, Counter of kernel sites ``(work, dims items)``) of one
    fold (``train`` False) or one training step of a (b, s, r) batch: every
    pass's forward, and for a step the last pass's backward; a recompute is
    not counted.

    Both grow by the same amount with each Evoformer block, so the model
    is counted at one and at two blocks and the difference taken
    ``n_blocks`` - 1 more times."""
    flops1, sites1 = _count(dataclasses.replace(dims, n_blocks=1), b, s, r,
                            train)
    if dims.n_blocks == 1:
        return flops1, sites1
    flops2, sites2 = _count(dataclasses.replace(dims, n_blocks=2), b, s, r,
                            train)
    extra = dims.n_blocks - 1
    block = sites2 - sites1
    return (flops1 + extra * (flops2 - flops1),
            sites1 + Counter({k: n * extra for k, n in block.items()}))


def _count(dims: Dims, b: int, s: int, r: int, train: bool):
    """``item_work``'s item at ``dims``, counted whole."""
    sites = Sites()
    model = AlphaFold(dims, sites=sites, row_bytes=1 << 62)
    shapes = param_shapes(dims)
    params = rebuild(shapes, [torch.empty(sh, device="meta",
                                          requires_grad=train)
                              for _, sh in leaves(shapes)])
    batch = meta_batch(b, s, r)
    if not train:
        with torch.no_grad():
            flops, _ = count_flops(model.forward, params, batch)
        return flops, _tally(sites)
    keeps = []
    for _ in range(dims.n_blocks):
        block = {}
        for site, axis in DROPOUT_SITES.items():
            shape = ([b, s, r, dims.d_msa] if site == "msa_row"
                     else [b, r, r, dims.d_pair])
            shape[axis] = 1
            block[site] = torch.empty(shape, device="meta")
        keeps.append(block)

    def step():
        out = model.forward(params, batch, keeps=keeps, train=True)
        loss = alphafold_loss(out, batch)
        torch.autograd.grad(loss, [t for _, t in leaves(params)],
                            allow_unused=True)

    flops, _ = count_flops(step)
    return flops, _tally(sites)


def _tally(sites: Sites) -> Counter:
    return Counter((w, tuple(sorted(d.items()))) for w, d in sites.calls)
