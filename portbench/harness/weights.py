"""Seeded inputs: the seeds a run derives from ``--seed``, and the weights,
drawn on the device in one call.

Every weight ``w`` (d_in, d_out) is N(0, 1)/sqrt(d_in), times the
configuration's ``weight_scales`` entry for the layer that holds it where
there is one; a LayerNorm ``gamma`` 1 + 0.1 N(0, 1); every other leaf
(biases, ``beta``, point weights) 0.1 N(0, 1): no zero-initialised
projection hides the computation behind it. The values depend on the
seed, the scales and the tree of shapes only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.alphafold import leaves, rebuild

# What each derived seed is for.
WEIGHTS, INPUTS, DROPOUT, SAMPLE = range(4)


def derived_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for ``purpose`` from the run's ``--seed`` (any
    non-negative whole number)."""
    ss = np.random.SeedSequence([int(seed), purpose])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def input_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, INPUTS))


def draw_weights(shapes: dict, seed: int, device,
                 scales: dict | None = None) -> dict:
    """The tree of ``shapes`` filled from one draw of a generator on
    ``device`` seeded from ``seed``; ``scales`` {layer name: factor} on the
    weights of the layers so named."""
    scales = scales or {}
    entries = list(leaves(shapes))
    sizes = [math.prod(shape) for _, shape in entries]
    gen = torch.Generator(device=device).manual_seed(
        derived_seed(seed, WEIGHTS))
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = []
    for (path, shape), part in zip(entries, torch.split(z, sizes)):
        part = part.view(shape)
        key = path[-1]
        if key == "w":
            scale = scales.get(path[-2], 1.0) if len(path) > 1 else 1.0
            out.append(part * (scale / math.sqrt(shape[0])))
        elif key == "gamma":
            out.append(1.0 + 0.1 * part)
        else:
            out.append(0.1 * part)
    return rebuild(shapes, out)
