"""Tensor-parallel Evoformer, the paper's baseline (§IV.B.1, Table III): the
port's counterpart of the reference's ``core/tp.py``.

Megatron-style column and row parallelism over a process group, on the
same parameter tree as the local and DAP Evoformer, each rank slicing the
weights it needs: the QKV (merged q|k|v, sliced per segment), gate and
pair-bias projections are column-parallel (the rank's heads), the output
projection is row-parallel and ends in an all-reduce; the transitions are
column-then-row with an all-reduce. The outer-product-mean and the
triangle updates cannot be split this way (Table III) and run replicated
through ``LocalDist``. Activations are whole on every rank. Attention goes
through ``layers.attention.evoformer_attention`` (the scores
materialized, then the fused softmax: K4 on the card) at H/N heads.

Gradients follow Megatron's f/g pair: the all-reduce after a row-parallel
product (g, ``dist.all_reduce``) has the identity as its backward, and a
replicated input entering a column-parallel product (f,
``dist.copy_to_ranks``) is the identity forward and all-reduces its
gradient. A sliced parameter's gradient is summed over the ranks (each rank
holds its slice's); a replicated one's (LayerNorms, the output biases, the
outer-product-mean, the triangle updates) is whole on every rank already
and is not. Each rank's gradients are then the local stack's.

Six all-reduces a block forward (paper Table III). The group's size must
divide the heads: the pair stack's 4 heads cap TP at 4 ranks, the paper's
argument for DAP.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.alphafold import EvoformerConfig
from repro_torch.core.dist import LocalDist, ProcessGroupDist
from repro_torch.core.evoformer import (NEG_INF, _residual_add,
                                        outer_product_mean,
                                        transpose_pair,
                                        triangle_mult_incoming,
                                        triangle_mult_outgoing)
from repro_torch.exec.plan import current_plan, use_plan
from repro_torch.kernels import ops
from repro_torch.layers.attention import evoformer_attention
from repro_torch.layers.norms import layer_norm


class _SliceParam(torch.autograd.Function):
    """The rank's share of a parameter along ``dim``: of each of ``groups``
    equal segments, the rank's 1/N, concatenated. Backward: the slice's
    gradient in its place in a zero tensor of the parameter's shape,
    all-reduced, so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, w, dist, dim, groups):
        n, rank = dist.axis_size, dist.rank
        seg = w.shape[dim] // groups
        loc = seg // n
        ctx.dist, ctx.dim, ctx.shape = dist, dim, w.shape
        ctx.starts = [g * seg + rank * loc for g in range(groups)]
        ctx.loc = loc
        return torch.cat([w.narrow(dim, s, loc) for s in ctx.starts], dim)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        for i, s in enumerate(ctx.starts):
            full.narrow(ctx.dim, s, ctx.loc).copy_(
                g.narrow(ctx.dim, i * ctx.loc, ctx.loc))
        return (ctx.dist.all_reduce_tensor(full, phase="backward"), None,
                None, None)


def _cols(w, dist, groups: int = 1):
    return _SliceParam.apply(w, dist, w.ndim - 1, groups)


def _rows(w, dist):
    return _SliceParam.apply(w, dist, 0, 1)


def _bias_heads(p_bias, z_n, dist):
    """The rank's heads of a pair bias, column-parallel: (B, H/N, R, C)."""
    return (dist.copy_to_ranks(z_n)
            @ _cols(p_bias["w"], dist).to(z_n.dtype)).permute(0, 3, 1, 2)


def tp_gated_attention(p_attn, x_n, bias_loc, key_mask, heads: int,
                       head_dim: int, dist):
    """x_n (N, S, d) whole on every rank; bias_loc (B, H/N, S, S), the
    rank's heads, or None; key_mask (N, S) in {0, 1}. Column-parallel QKV
    and gate, row-parallel output and its all-reduce."""
    n = dist.axis_size
    h_loc = heads // n
    dt = x_n.dtype
    x = dist.copy_to_ranks(x_n)
    y = x @ _cols(p_attn["wqkv"]["w"], dist, groups=3).to(dt)
    if "b" in p_attn["wqkv"]:
        y = y + _cols(p_attn["wqkv"]["b"], dist, groups=3).to(dt)
    q, k, v = (t.unflatten(-1, (h_loc, head_dim))
               for t in torch.chunk(y, 3, dim=-1))
    mask = torch.where(key_mask > 0, 0.0, NEG_INF).to(torch.float32)
    ctx = evoformer_attention(q, k, v, bias=bias_loc, mask=mask)
    flat = ctx.flatten(-2)
    if "wg" in p_attn:
        g = x @ _cols(p_attn["wg"]["w"], dist).to(dt)
        flat = ops.bias_sigmoid_mul(g, _cols(p_attn["wg"]["b"], dist), flat)
    out = dist.all_reduce(flat @ _rows(p_attn["wo"]["w"], dist).to(dt))
    if "b" in p_attn["wo"]:
        out = out + p_attn["wo"]["b"].to(dt)
    return out


def tp_transition(p, x, dist):
    """LN, column-parallel first linear and ReLU, row-parallel second
    linear and its all-reduce."""
    x_n = dist.copy_to_ranks(layer_norm(p["ln"], x))
    dt = x_n.dtype
    mlp = p["mlp"]
    h = torch.relu(x_n @ _cols(mlp["wi"]["w"], dist).to(dt)
                   + _cols(mlp["wi"]["b"], dist).to(dt))
    out = dist.all_reduce(h @ _rows(mlp["wo"]["w"], dist).to(dt))
    return out + mlp["wo"]["b"].to(dt)


def tp_evoformer_block(params, msa, pair, msa_mask, seq_mask, pair_mask, *,
                       cfg: EvoformerConfig, dist):
    """One TP block: every tensor whole on every rank, the weights split."""
    b, s, r, _ = msa.shape
    local = LocalDist()

    # MSA row attention (TP over heads), the pair bias column-parallel.
    p = params["msa_row"]
    bias = _bias_heads(p["bias"], layer_norm(p["ln_z"], pair), dist)
    x = layer_norm(p["ln_m"], msa).reshape(b * s, r, cfg.d_msa)
    key_mask = seq_mask[:, None, :].expand(b, s, r).reshape(b * s, r)
    upd = tp_gated_attention(p["attn"], x, bias, key_mask, cfg.msa_heads,
                             cfg.head_dim, dist)
    msa = _residual_add(upd.reshape(b, s, r, cfg.d_msa), msa)

    # MSA column attention.
    p = params["msa_col"]
    x = layer_norm(p["ln"], msa).transpose(1, 2).reshape(b * r, s, cfg.d_msa)
    key_mask = msa_mask.transpose(1, 2).reshape(b * r, s)
    upd = tp_gated_attention(p["attn"], x, None, key_mask, cfg.msa_heads,
                             cfg.head_dim, dist)
    msa = _residual_add(upd.reshape(b, r, s, cfg.d_msa).transpose(1, 2), msa)
    msa = _residual_add(tp_transition(params["msa_trans"], msa, dist), msa)

    # The outer-product-mean and the triangle updates: replicated.
    pair = _residual_add(outer_product_mean(params["opm"], msa, msa_mask,
                                            cfg, dist=local), pair)
    pair = _residual_add(triangle_mult_outgoing(
        params["tri_mult_out"], pair, pair_mask, cfg, dist=local), pair)
    pair = _residual_add(triangle_mult_incoming(
        params["tri_mult_in"], transpose_pair(pair, local),
        transpose_pair(pair_mask, local), cfg, dist=local), pair)

    # Triangle attentions (TP over the pair heads).
    for name, transpose in (("tri_attn_start", False),
                            ("tri_attn_end", True)):
        p = params[name]
        z_n = layer_norm(p["ln"], pair.transpose(1, 2) if transpose else pair)
        bias = _bias_heads(p["bias"], z_n, dist)
        key_mask = seq_mask[:, None, :].expand(b, r, r).reshape(b * r, r)
        upd = tp_gated_attention(p["attn"], z_n.reshape(b * r, r, cfg.d_pair),
                                 bias, key_mask, cfg.pair_heads, cfg.head_dim,
                                 dist).reshape(b, r, r, cfg.d_pair)
        pair = _residual_add(upd.transpose(1, 2) if transpose else upd, pair)

    pair = _residual_add(tp_transition(params["pair_trans"], pair, dist), pair)
    return msa, pair


def tp_evoformer_stack(group, cfg: EvoformerConfig, *, remat: bool = True):
    """``fn(params, msa, pair, msa_mask, seq_mask, pair_mask) -> (msa,
    pair)``: the stack under TP on ``group`` (None: the default group),
    every tensor whole on every rank. ``remat`` checkpoints each block
    where a graph is built (the recompute runs under the forward's plan and
    launches the same all-reduces). A group size that does not divide the
    MSA and pair heads raises ValueError (the reference's scaling limit)."""
    d = ProcessGroupDist(group)
    n = d.axis_size
    if cfg.msa_heads % n or cfg.pair_heads % n:
        raise ValueError(
            f"TP over {n} ranks needs the group's size to divide the heads: "
            f"msa_heads={cfg.msa_heads}, pair_heads={cfg.pair_heads}")

    def fn(params, msa, pair, msa_mask, seq_mask, pair_mask):
        plan = current_plan()

        def block_under_plan(*args, **kw):
            with use_plan(plan):
                return tp_evoformer_block(*args, **kw)

        for p in params:
            if remat and torch.is_grad_enabled():
                with set_checkpoint_early_stop(False):
                    msa, pair = checkpoint(
                        block_under_plan, p, msa, pair, msa_mask, seq_mask,
                        pair_mask, cfg=cfg, dist=d, use_reentrant=False)
            else:
                msa, pair = tp_evoformer_block(p, msa, pair, msa_mask,
                                               seq_mask, pair_mask, cfg=cfg,
                                               dist=d)
        return msa, pair

    return fn
