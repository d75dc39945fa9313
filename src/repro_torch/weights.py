"""Parameters across the two packages, and seeded randomisation.

The reference's parameters are a pytree of nested dicts. Handed over as
nested dicts of numpy arrays, ``params_from_numpy`` turns them into the
port's parameters: the same keys and layouts, except that the Evoformer
stack's leading layer axis (``init_evoformer_stack`` in the reference)
becomes a list of per-block dicts. ``params_to_numpy`` is the inverse.
``decoder_params_from_numpy`` / ``decoder_params_to_numpy`` do the same for
a decoder LM: the reference stacks each stage's layers on a leading axis
(``params["stages"][i]``, and each stage of a KV cache), the port keeps a
list of per-layer dicts.

``randomize_tree`` overwrites every leaf with seeded values, so that no
zero-initialised output projection hides the computation behind it (a
weight, ``w`` or an MoE expert bank ``wi``/``wo``, scaled by its fan-in);
``random_params_like`` draws a tree of the same rules on a device, for
full-width models whose numpy draw would take too long.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

_STACKED = "evoformer"


def _to_torch(tree, device, dtype):
    """Floating leaves become ``dtype``; integer leaves keep theirs."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a).to(device)
    return torch.as_tensor(np.array(a, dtype=np.float32)).to(device=device,
                                                             dtype=dtype)


def _to_numpy(tree):
    """Floating leaves as fp32 numpy arrays; integer leaves keep theirs."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.detach().to("cpu", torch.float32).numpy()
    return tree.detach().cpu().numpy()


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


def params_from_numpy(tree: dict, device=None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameters on
    ``device``: None means the card (``device.resolve_device``, which
    raises where there is none), ``"cpu"`` the explicit opt-in."""
    device = resolve_device(device)
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


# Leaves drawn as weights, N(0, 1) / sqrt(d_in): a dense ``w`` (d_in,
# d_out) and the MoE expert banks ``wi`` (E, d, 2f) and ``wo`` (E, f, d),
# stacked on a layer axis or not. (SwiGLU's ``wi``/``wo`` are dicts that
# hold a ``w``.)
_WEIGHTS = ("w", "wi", "wo")


def randomize_tree(tree, seed: int):
    """Overwrite every leaf of a numpy parameter tree with seeded values:
    a weight (``_WEIGHTS``: ``w`` (d_in, d_out) or an expert bank ``wi``/
    ``wo`` (E, d_in, d_out)), stacked or not, gets N(0, 1)/sqrt(d_in);
    a LayerNorm ``gamma`` gets 1 + 0.1 N(0, 1); every other leaf (biases,
    ``beta``, point weights) 0.1 N(0, 1). Leaves are visited in sorted key
    order (a list, such as a decoder's stages, in its order), so the
    result depends on the seed and the tree's shape only."""
    rng = np.random.default_rng(seed)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(n, key) for n in node]
        shape = np.shape(node)
        z = rng.standard_normal(shape).astype(np.float32)
        if key in _WEIGHTS:
            return z / np.float32(np.sqrt(shape[-2]))
        if key == "gamma":
            return 1.0 + np.float32(0.1) * z
        return np.float32(0.1) * z

    return walk(tree, None)


# ---------------------------------------------------------------------------
# Decoder LMs
# ---------------------------------------------------------------------------

def decoder_params_from_numpy(tree: dict, device=None,
                              dtype: torch.dtype = torch.float32) -> dict:
    """A reference decoder tree (``init_model``'s, numpy leaves) -> the
    port's, each stage a list of per-layer dicts, on ``device`` (None: the
    card, ``"cpu"`` the opt-in). Floating leaves become ``dtype``, integer
    leaves keep theirs. A reference KV cache (``init_cache``: a list of
    stacked stages) converts the same way under the key ``"stages"``:
    ``decoder_params_from_numpy({"stages": cache}, ...)["stages"]``."""
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k == "stages":
            out[k] = [[_to_torch(_unstack(stage, i), device, dtype)
                       for i in range(_n_layers(stage))] for stage in v]
        else:
            out[k] = _to_torch(v, device, dtype)
    return out


def decoder_params_to_numpy(params: dict) -> dict:
    """The inverse of ``decoder_params_from_numpy``: floating leaves as
    fp32 numpy arrays, each stage's layers stacked on a leading axis."""
    out = {}
    for k, v in params.items():
        if k == "stages":
            out[k] = [_stack([_to_numpy(layer) for layer in stage])
                      for stage in v]
        else:
            out[k] = _to_numpy(v)
    return out


def random_params_like(skeleton, seed: int, device=None,
                       dtype: torch.dtype = torch.float32):
    """A tree of ``skeleton``'s structure and shapes (its leaves may lie on
    the ``meta`` device) drawn on ``device`` from a generator seeded with
    ``seed``, by ``randomize_tree``'s rules: a weight (``w``, ``wi``,
    ``wo``) N(0, 1) / sqrt(d_in), a ``gamma`` 1 + 0.1 N(0, 1), every other leaf 0.1 N(0, 1);
    leaves visited in sorted key order, lists in order. Not the numpy
    draw's values: the same distribution, drawn where the model runs."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(n, key) for n in node]
        z = torch.randn(tuple(node.shape), generator=gen, device=device,
                        dtype=torch.float32)
        if key in _WEIGHTS:
            z = z / float(np.sqrt(node.shape[-2]))
        elif key == "gamma":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.to(dtype)

    return walk(skeleton, None)
