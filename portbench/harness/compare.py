"""The numbers ``correct`` compares, each beside its limit."""
from __future__ import annotations

import math
import statistics

import torch


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in fp64 on the CPU; inf where either is
    not finite."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if got.shape != want.shape:
        return math.inf
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return math.inf
    return float(torch.linalg.norm(got - want)
                 / torch.linalg.norm(want).clamp_min(1e-30))


def leaf_gap(got: list[float], want: list[float], keep=None) -> float:
    """The worst leaf's gap of norms: |got - want| over the larger of the
    leaf's reference norm and the median leaf's; ``keep`` selects leaves."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    if len(got) != len(want) or not idx:
        return math.inf
    med = statistics.median(want[i] for i in idx)
    worst = 0.0
    for i in idx:
        if not (math.isfinite(got[i]) and math.isfinite(want[i])):
            return math.inf
        worst = max(worst, abs(got[i] - want[i]) / max(want[i], med, 1e-30))
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(whether every number lies within its limit, the rows
    [name, value, limit])."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        rows.append([name, value, limit])
        ok = ok and math.isfinite(value) and value <= limit
    return ok, rows
