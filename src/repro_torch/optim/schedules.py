"""Learning-rate schedules: pure functions of the integer step, in fp32,
as the reference computes them. Each returns a 0-d fp32 tensor."""
from __future__ import annotations

import math

import torch


def linear_warmup(step, base_lr: float, warmup_steps: int) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    return base_lr * torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, base_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                       0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
