"""AdamW and LAMB over the port's parameter tree (nested dicts, the
Evoformer's blocks a list), the reference's update rules line for line.

The optimizer state is fp32 whatever the parameters' dtype. Updates are
functional, as in the reference: they return new tensors and leave their
inputs alone. The step count, the bias corrections and the learning rate
are 0-d tensors on the CPU, which PyTorch combines with tensors on the card
without a copy per leaf. There is no ``torch.optim`` here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.layers.params import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the CPU
    m: dict
    v: dict


def _unzip3(tree):
    """A tree of 3-tuples -> three trees."""
    return tuple(_pick(tree, i) for i in range(3))


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def _zeros_like(params, dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def adamw_init(params, *, state_dtype=torch.float32) -> OptState:
    return OptState(torch.zeros((), dtype=torch.int32),
                    _zeros_like(params, state_dtype),
                    _zeros_like(params, state_dtype))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, lr, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g = g.float()
        sdt = m.dtype
        m = b1 * m.float() + (1 - b1) * g
        v = b2 * v.float() + (1 - b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            update = update + weight_decay * p.float()
        return ((p.float() - lr * update).to(p.dtype), m.to(sdt),
                v.to(sdt))

    new_p, new_m, new_v = _unzip3(tree_map(upd, params, grads, state.m,
                                           state.v))
    return new_p, OptState(step, new_m, new_v)


def lamb_init(params, *, state_dtype=torch.float32) -> OptState:
    return adamw_init(params, state_dtype=state_dtype)


@torch.no_grad()
def lamb_update(params, grads, state: OptState, lr, *, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-6,
                weight_decay: float = 0.01):
    """LAMB (You et al.): Adam direction with per-tensor trust ratio.

    The trust ratio is taken per leaf of the reference's tree, where the
    Evoformer's blocks are one tensor stacked on a layer axis: so the norms
    of an Evoformer parameter span all its blocks, as they do there."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(ps, gs, ms, vs):
        """One reference leaf: lists of the tensors it stacks."""
        pfs, new_m, new_v, rs = [], [], [], []
        for p, g, m, v in zip(ps, gs, ms, vs):
            g = g.float()
            pf = p.float()
            m2 = b1 * m.float() + (1 - b1) * g
            v2 = b2 * v.float() + (1 - b2) * g * g
            rs.append((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                      + weight_decay * pf)
            pfs.append(pf)
            new_m.append(m2.to(m.dtype))
            new_v.append(v2.to(v.dtype))
        w_norm = torch.linalg.norm(torch.stack([torch.linalg.norm(x)
                                                for x in pfs]))
        r_norm = torch.linalg.norm(torch.stack([torch.linalg.norm(x)
                                                for x in rs]))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = [(pf - lr * trust * r).to(p.dtype)
                 for p, pf, r in zip(ps, pfs, rs)]
        return list(zip(new_p, new_m, new_v))

    new_p, new_m, new_v = _unzip3(_stacked_map(upd, params, grads, state.m,
                                               state.v))
    return new_p, OptState(step, new_m, new_v)


def _stacked_map(fn, *trees):
    """Map ``fn`` over the reference's leaves: a leaf outside a list is a
    one-tensor list; under a list of per-block dicts (the Evoformer) a leaf
    is the list of that parameter's per-block tensors. ``fn`` returns one
    result per tensor; they are put back in the port's layout."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stacked_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, list):
        return _stacked_map_blocks(fn, *trees)
    return fn(*([t] for t in trees))[0]


def _stacked_map_blocks(fn, *lists):
    """``lists``: per tree, a list of per-block trees of one structure."""
    n = len(lists[0])
    out = [None] * n

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        gather = [[_at(blk, path) for blk in lst] for lst in lists]
        for i, r in enumerate(fn(*gather)):
            out[i] = _put(out[i], path, r)

    walk((), lists[0][0])
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    if not path:
        return value
    tree = {} if tree is None else tree
    tree[path[0]] = _put(tree.get(path[0]), path[1:], value)
    return tree


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global L2 norm is at most ``max_norm``,
    the norm before clipping)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-6), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def make_optimizer(name: str) -> tuple[Callable, Callable]:
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "lamb":
        return lamb_init, lamb_update
    raise ValueError(f"unknown optimizer {name!r}")
