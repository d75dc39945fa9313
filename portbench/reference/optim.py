"""The training step's update in plain fp32 PyTorch: the global-norm clip,
the warm-up cosine learning rate and AdamW, as FastFold's step applies
them, over flat lists of tensors."""
from __future__ import annotations

import math

import torch


def lr_at(step: int, base_lr: float, warmup_steps: int, total_steps: int,
          final_frac: float = 0.1) -> float:
    """The rate of 0-based ``step``: linear warm-up to ``base_lr``, then a
    cosine decay to ``final_frac`` of it."""
    warm = min((step + 1) / max(1, warmup_steps), 1.0)
    prog = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps),
                   0.0), 1.0)
    return base_lr * warm * (final_frac + (1 - final_frac) * 0.5
                             * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def clip(grads: list, max_norm: float):
    """(gradients scaled to a global L2 norm of at most ``max_norm``, the
    norm before)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads], norm


@torch.no_grad()
def adamw(params: list, grads: list, m: list, v: list, step: int, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """One AdamW update at 1-based ``step``: (params, m, v), new lists."""
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    out_p, out_m, out_v = [], [], []
    for p, g, mi, vi in zip(params, grads, m, v):
        mi = b1 * mi + (1 - b1) * g
        vi = b2 * vi + (1 - b2) * g * g
        upd = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
        if weight_decay:
            upd = upd + weight_decay * p
        out_p.append(p - lr * upd)
        out_m.append(mi)
        out_v.append(vi)
    return out_p, out_m, out_v
