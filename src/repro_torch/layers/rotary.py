"""Rotary position embeddings (half-split rotation, LLaMA-style), in fp32."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim / 2,) inverse frequencies ``theta ** -(2i / head_dim)``."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {head_dim}")
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). The halves
    (x1, x2) become (x1 cos - x2 sin, x2 cos + x1 sin); out in x's dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs       # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
