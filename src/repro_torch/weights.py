"""Parameters across the two packages, and seeded randomisation.

The reference's parameters are a pytree of nested dicts. Handed over as
nested dicts of numpy arrays, ``params_from_numpy`` turns them into the
port's parameters: the same keys and layouts, except that the Evoformer
stack's leading layer axis (``init_evoformer_stack`` in the reference)
becomes a list of per-block dicts. ``params_to_numpy`` is the inverse.

``randomize_tree`` overwrites every leaf with seeded values, so that no
zero-initialised output projection hides the computation behind it.
"""
from __future__ import annotations

import numpy as np
import torch

_STACKED = "evoformer"


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32)).to(device=device,
                                                                dtype=dtype)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.shape(tree)[0]


def params_from_numpy(tree: dict, device="cpu",
                      dtype: torch.dtype = torch.float32) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameters."""
    out = {}
    for k, v in tree.items():
        if k == _STACKED:
            out[k] = [_to_torch(_unstack(v, i), device, dtype)
                      for i in range(_n_layers(v))]
        else:
            out[k] = _to_torch(v, device, dtype)
    return out


def params_to_numpy(params: dict) -> dict:
    """The port's parameters -> the reference's tree of numpy arrays."""
    out = {}
    for k, v in params.items():
        if k == _STACKED:
            out[k] = _stack([_to_numpy(p) for p in v])
        else:
            out[k] = _to_numpy(v)
    return out


def randomize_tree(tree, seed: int):
    """Overwrite every leaf of a numpy parameter tree with seeded values:
    a weight ``w`` (d_in, d_out), stacked or not, gets N(0, 1)/sqrt(d_in);
    a LayerNorm ``gamma`` gets 1 + 0.1 N(0, 1); every other leaf (biases,
    ``beta``, point weights) 0.1 N(0, 1). Leaves are visited in sorted key
    order, so the result depends on the seed and the tree's shape only."""
    rng = np.random.default_rng(seed)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        shape = np.shape(node)
        z = rng.standard_normal(shape).astype(np.float32)
        if key == "w":
            return z / np.float32(np.sqrt(shape[-2]))
        if key == "gamma":
            return 1.0 + np.float32(0.1) * z
        return np.float32(0.1) * z

    return walk(tree, None)
