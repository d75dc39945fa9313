"""Mixture-of-Experts FFN (DeepSeek-MoE style: shared plus fine-grained
routed experts, top-k softmax routing with capacity-bounded dispatch): the
port of the reference's ``models/moe.py``, plain PyTorch as the
reference's is plain JAX.

Dispatch as in the reference: token-choice top-k gates, then each expert
takes its top-C tokens by router probability (tokens not routed to it
score -1), inside each of ``n_groups`` token groups. Two points where the
port must pin what PyTorch leaves open:

* **Ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values, and in the per-expert top-C every token not routed to the
  expert scores -1.0, so ties are the rule. Both selections here are a
  stable descending sort, which keeps that order on every device.
* **The combine.** The reference scatter-adds each expert's outputs into
  its group's tokens in the compute dtype, in the order it flattens them
  (experts ascending). The port sums each token's contributions in that
  order, one add per routed expert, with no atomics, so two runs on the
  card give the same bits. A selected token that was not routed to the
  expert carries gate 0 and adds an exact zero; it is left out.

Capacity couples the tokens of a call: where it binds, one token's
routing depends on the others, so a prefill followed by decode steps is
not a recompute of the whole sequence (only at ``capacity == n`` is it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.params import Params, trunc_normal


def init_moe(generator: torch.Generator, d_model: int, moe: MoEConfig,
             dtype=torch.float32) -> Params:
    f = moe.d_ff_expert
    p: Params = {
        "router": {"w": trunc_normal(generator, (d_model, moe.n_experts), 1.0,
                                     dtype)},
        "experts": {
            "wi": trunc_normal(generator, (moe.n_experts, d_model, 2 * f),
                               1.0, dtype),
            "wo": torch.zeros((moe.n_experts, f, d_model), dtype=dtype),
        },
    }
    if moe.n_shared:
        p["shared"] = init_swiglu(generator, d_model, moe.n_shared * f, dtype)
    return p


def _capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(moe.capacity_factor * n_tokens * moe.top_k / moe.n_experts)
    return min(n_tokens, max(8, (c + 7) // 8 * 8))


def top_k_lower_first(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, xf: torch.Tensor, moe: MoEConfig):
    """The router on (N, d) tokens: fp32 probabilities (N, E), each token's
    top-k experts (N, k) and the renormalised gate matrix (N, E), zero
    where an expert is not chosen."""
    logits = xf.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_lower_first(probs, moe.top_k)
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    gate_full = torch.zeros_like(probs).scatter(1, top_i, top_p)
    return probs, top_i, gate_full


def moe_ffn(p: Params, x: torch.Tensor, moe: MoEConfig):
    """x: (B, S, d) -> (y (B, S, d), aux loss, an fp32 scalar)."""
    b, s, d = x.shape
    n = b * s
    e_n = moe.n_experts
    xf = x.reshape(n, d)
    dt = x.dtype
    probs, top_i, gate_full = route(p, xf, moe)

    # Per-expert top-C token selection inside each of G token groups.
    g_groups = moe.n_groups if n % moe.n_groups == 0 else 1
    ng = n // g_groups
    cap_g = _capacity(ng, moe)
    cap = g_groups * cap_g
    scores = torch.where(gate_full > 0, probs, -1.0)
    scores_g = scores.reshape(g_groups, ng, e_n).transpose(1, 2)
    _, tok_g = top_k_lower_first(scores_g, cap_g)             # (G, E, Cg)
    gate_g = gate_full.reshape(g_groups, ng, e_n).transpose(1, 2)
    ge = torch.gather(gate_g, 2, tok_g)                       # (G, E, Cg)
    xg = xf.reshape(g_groups, ng, d)
    rows = torch.arange(g_groups, device=x.device)[:, None]
    xe = xg[rows, tok_g.reshape(g_groups, -1)].reshape(
        g_groups, e_n, cap_g, d)
    # Expert-major (E, C, d): the reference's expert-parallel boundary.
    xe = xe.transpose(0, 1).reshape(e_n, cap, d)
    ge_e = ge.transpose(0, 1).reshape(e_n, cap)

    gu = torch.bmm(xe.to(dt), p["experts"]["wi"].to(dt))
    g, u = gu.chunk(2, dim=-1)
    h = F.silu(g.float()).to(dt) * u
    ye = torch.bmm(h, p["experts"]["wo"].to(dt))
    ye = ye * ge_e[..., None].to(dt)

    # The combine: slot_of[g, t, e] is the row of expert e's group-g
    # outputs that holds token t, -1 where e did not take t.
    ye_g = ye.reshape(e_n, g_groups, cap_g, d).transpose(0, 1)
    routed = torch.gather(gate_g, 2, tok_g) > 0
    slot_of = torch.full((g_groups, e_n, ng), -1, dtype=torch.long,
                         device=x.device)
    slots = torch.arange(cap_g, device=x.device).expand_as(tok_g)
    slot_of.scatter_(2, tok_g, torch.where(routed, slots, -1))
    slot_of = slot_of.transpose(1, 2).reshape(n, e_n)         # (N, E)
    experts = torch.sort(top_i, dim=-1).values                # ascending
    token_group = torch.arange(n, device=x.device) // ng
    y = torch.zeros((n, d), dtype=dt, device=x.device)
    for j in range(moe.top_k):
        e = experts[:, j]
        c = slot_of.gather(1, e[:, None])[:, 0]
        val = ye_g[token_group, e, c.clamp_min(0)]
        y = y + torch.where((c >= 0)[:, None], val, torch.zeros_like(val))

    if "shared" in p:
        y = y + swiglu(p["shared"], xf.to(dt))

    # Load-balance auxiliary loss (Switch/DeepSeek form).
    frac = (gate_full > 0).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    aux = moe.aux_weight * e_n * torch.sum(frac * mean_p)
    return y.reshape(b, s, d), aux
