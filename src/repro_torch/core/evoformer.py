"""Evoformer (AlphaFold 2 trunk), inference and training, on one device or
under Dynamic Axial Parallelism.

The port of the reference's ``evoformer_block`` / ``evoformer_stack``. Every
site takes the ``dist`` backend (``core/dist.py``; None resolves the current
plan's ``ParallelPolicy``), and the block follows the reference's sharding
state machine (paper Fig. 6), with N the group's size:

  MSA   (B, s/N, r, Hm): sharded on s for the row attention; all-to-all #1
        moves it, and its mask, to the r shard for the column attention,
        the transition and the outer-product-mean; all-to-all #2 swaps it
        back, triggered right after the outer-product-mean and blocked at
        the end of the block (the Duality-Async window, ``core/duality.py``).
  pair  (B, r/N, r, Hz): sharded on i; the incoming update and the
        ending-node attention run on the all-to-all-transposed pair.

All-gathers materialise what crosses the shard: the (B, H, r, r) pair biases
of the three biased attentions (across their QKV projections), the
outer-product-mean's right projection and its mask, and each triangle
update's gated, masked b (across its left operands). Under ``LocalDist``
every collective is the identity, ``transpose_pair`` an axis swap and each
window empty. Every LayerNorm goes through the LayerNorm kernel and every
attention output gate through the gating kernel.

Each of the three kernel sites takes one of two branches, chosen as the
reference chooses them, by the current ``ExecutionPlan`` (``exec/plan.py``)
through ``ops.fused_*_supported``:
- attention (MSA row with pair bias, MSA column, triangle start and end with
  pair bias): the fused branch ``ops.fused_attention`` (the flash-attention
  kernels on the card), or the scores-materialized branch: the
  (B, G, H, S, S) scores as one product, ``ops.fused_softmax`` (the fused
  softmax kernel on the card), the context as a second product;
- the two triangular multiplicative updates: ``ops.fused_triangle_mult``
  (the fused triangle kernel), or the materialized branch: the gated a and
  b, the (B, r, r, c) product, the output LayerNorm, the projection and the
  gating kernel;
- the outer-product-mean: ``ops.fused_outer_product_mean`` (the fused OPM
  kernel), or the materialized (B, r, r, c, c) outer product, whole or in j
  blocks of ``cfg.opm_chunk``.
The default plan takes the fused branches where the kernels take the widths
(MINI and FULL); ``KernelPolicy(attention="oracle")``,
``preset("triangle-oracle")`` and ``preset("oracle")`` select the
materialized ones, and so does a width outside a kernel's envelope.

Chunking (the knobs of ``EvoformerConfig``, filled per forward by AutoChunk,
``memory/autochunk.py``): ``inference_chunk`` runs the G groups of each of
the four attention sites in sequential chunks (paper §V.C), on either
branch; ``attn_kv_tile``, ``tri_k_tile`` and ``opm_s_tile`` go down to the
fused ops, and ``opm_chunk`` sets the j blocks of the materialized
outer-product-mean. None of them changes a number.

Training: the six residual adds that the reference drops out go through
``ops.bias_dropout_add`` with their keep masks (drawn by the caller, see
``core.alphafold.draw_dropout_keeps``, at the reduced shape of the
reference's shared axis; under DAP every rank draws them whole from the same
generator and ``evoformer_stack`` takes its own shard of each), and
``evoformer_stack(remat=True)`` recomputes each
block in the backward (``torch.utils.checkpoint``) under the plan the forward
ran under. ``cfg.remat_policy`` says what a block keeps: "nothing" (the
reference's ``nothing_saveable``) only its inputs, "dots" (its
``dots_saveable``) also the outputs of its matrix products. Masks are never
drawn inside a checkpointed block, so the recompute sees the same ones.
The recompute also runs under the forward's ``dist``, and launches the block's
collectives again in the forward's order on every rank.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn,
                                    set_checkpoint_early_stop)

from repro_torch.configs.alphafold import EvoformerConfig
from repro_torch.core import duality
from repro_torch.core.dist import LocalDist
from repro_torch.exec.plan import current_plan, use_plan
from repro_torch.kernels import ops
from repro_torch.layers.attention import (AttnDims, init_attention,
                                          output_proj, project_qkv)
from repro_torch.layers.mlp import init_transition, transition
from repro_torch.layers.norms import init_layer_norm, layer_norm
from repro_torch.layers.params import (Params, dense, init_dense, tree_leaves,
                                       tree_map)

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_evoformer_block(generator: torch.Generator,
                         cfg: EvoformerConfig) -> Params:
    d_m, d_z = cfg.d_msa, cfg.d_pair
    hm, hz, hd = cfg.msa_heads, cfg.pair_heads, cfg.head_dim
    c_mult = cfg.tri_mult_dim
    g = generator

    def attn(d_in, heads, d_out):
        return init_attention(g, d_in, heads, heads, hd, gating=True,
                              out_bias=True, d_out=d_out)

    def tri_mult():
        return {
            "ln_in": init_layer_norm(d_z),
            "proj": init_dense(g, d_z, 2 * c_mult, bias=True),
            "gate": init_dense(g, d_z, 2 * c_mult, bias=True),
            "ln_out": init_layer_norm(c_mult),
            "out": init_dense(g, c_mult, d_z, bias=True, zero_init=True),
            "gate_out": init_dense(g, d_z, d_z, bias=True),
        }

    def tri_attn():
        return {
            "ln": init_layer_norm(d_z),
            "bias": init_dense(g, d_z, hz, bias=False),
            "attn": attn(d_z, hz, d_z),
        }

    return {
        "msa_row": {
            "ln_m": init_layer_norm(d_m),
            "ln_z": init_layer_norm(d_z),
            "bias": init_dense(g, d_z, hm, bias=False),
            "attn": attn(d_m, hm, d_m),
        },
        "msa_col": {"ln": init_layer_norm(d_m), "attn": attn(d_m, hm, d_m)},
        "msa_trans": {"ln": init_layer_norm(d_m),
                      "mlp": init_transition(g, d_m, cfg.transition_factor)},
        "opm": {
            "ln": init_layer_norm(d_m),
            "proj": init_dense(g, d_m, 2 * cfg.opm_dim, bias=True),
            "out": init_dense(g, cfg.opm_dim * cfg.opm_dim, d_z, bias=True,
                              zero_init=True),
        },
        "tri_mult_out": tri_mult(),
        "tri_mult_in": tri_mult(),
        "tri_attn_start": tri_attn(),
        "tri_attn_end": tri_attn(),
        "pair_trans": {"ln": init_layer_norm(d_z),
                       "mlp": init_transition(g, d_z, cfg.transition_factor)},
    }


def init_evoformer_stack(generator: torch.Generator,
                         cfg: EvoformerConfig) -> list[Params]:
    """One parameter dict per block (the reference stacks them on a leading
    layer axis; ``weights.params_from_numpy`` unstacks that axis)."""
    return [init_evoformer_block(generator, cfg) for _ in range(cfg.n_blocks)]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

# The six residual adds that apply dropout, in the reference's order of its
# per-block rng split, with the axis of the update that shares one draw.
DROPOUT_SITES = {"msa_row": 2, "opm": 1, "tri_mult_out": 1, "tri_mult_in": 1,
                 "tri_attn_start": 1, "tri_attn_end": 2}


def _residual_add(upd: torch.Tensor, residual: torch.Tensor, rate: float = 0.0,
                  keep: torch.Tensor | None = None) -> torch.Tensor:
    """residual + dropout(upd): fp32 add, residual's dtype. ``keep`` is the
    reduced 0/1 mask shared along one axis, or None (no dropout)."""
    return ops.bias_dropout_add(upd, None, residual, rate, keep)


def _resolve(dist):
    return dist if dist is not None else current_plan().parallel.make_dist()


def transpose_pair(x: torch.Tensor, dist=None) -> torch.Tensor:
    """(B, i/N, j, ...) -> (B, j/N, i, ...): the all-to-all moves the shard
    from i to j (split 2, concatenate 1), the local swap finishes the
    transpose. On one device only the swap remains."""
    return _resolve(dist).all_to_all(x, split_axis=2,
                                     concat_axis=1).transpose(1, 2)


def _gated_attention(p_attn: Params, x_n: torch.Tensor,
                     bias, key_mask: torch.Tensor,
                     dims: AttnDims, chunk: int = 0,
                     kv_tile: int = 0, dist=None) -> torch.Tensor:
    """Group attention, 5D. x_n (B, G, S, d), G the groups in hand; bias
    (B, H, S, S) shared across G, a ``duality.trigger`` handle of its
    gather (blocked after the first QKV projection, the window's compute),
    or None; key_mask (B, G, S) in {0, 1}. The fused branch where the plan
    and the kernel's envelope allow it (through ``dist.sharded_attention``;
    ``kv_tile`` goes down to ``ops.fused_attention``), else the
    scores-materialized branch.

    ``chunk`` > 0: the paper's §V.C chunking, as the reference runs it: the
    G groups in sequential chunks of ``chunk`` (projections, attention and
    output projection of one chunk at a time), written into one output; a
    chunk that does not divide G runs whole."""
    dist = _resolve(dist)
    held = [bias]

    def bias_now():
        if held[0] is not None and not isinstance(held[0], torch.Tensor):
            held[0] = duality.block(held[0])
        return held[0]

    def attend(x_c, mask_c):
        q, k, v = project_qkv(p_attn, duality.mark(x_c, "qkv"), dims,
                              compute_dtype=x_c.dtype)
        bias = bias_now()
        scale = 1.0 / (q.shape[-1] ** 0.5)
        mask = torch.where(mask_c > 0, 0.0, NEG_INF).to(torch.float32)
        if (ops.fused_attention_supported(q.shape, kv_len=k.shape[2],
                                          dtype=q.dtype, device=q.device)
                and dist.sharded_attention_supported(q.shape)):
            ctx = dist.sharded_attention(q, k, v, bias=bias, mask=mask,
                                         scale=scale, kv_tile=kv_tile)
        else:
            # Sanctioned scores-materialized A/B fallback (oracle leg /
            # out-of-envelope shapes); the fused path above is production.
            # repro-lint: disable=R004
            scores = torch.einsum("bgihd,bgjhd->bghij", q, k)
            probs = ops.fused_softmax(scores, bias=bias, mask=mask,
                                      scale=scale)
            del scores
            ctx = torch.einsum("bghij,bgjhd->bgihd", probs,
                               v)  # repro-lint: disable=R004 -- same fallback
        return output_proj(p_attn, ctx, x_for_gate=x_c)

    g = x_n.shape[1]
    if not chunk or g % chunk != 0 or chunk >= g:
        return attend(x_n, key_mask)
    out = None
    for g0 in range(0, g, chunk):
        y = attend(x_n[:, g0:g0 + chunk], key_mask[:, g0:g0 + chunk])
        if out is None:
            out = y.new_empty(y.shape[:1] + (g,) + y.shape[2:])
        out[:, g0:g0 + chunk] = y
    return out


# ---------------------------------------------------------------------------
# Sub-modules (each takes the tensors in hand: the shards under DAP)
# ---------------------------------------------------------------------------

def msa_row_attention(p, msa, pair, seq_mask, cfg: EvoformerConfig,
                      dist=None):
    """msa (B, s/N, r, Hm) [s shard]; pair (B, r/N, r, Hz) [i shard];
    seq_mask (B, r). The pair bias is projected from the local pair rows
    and gathered on its row axis, across the LN and QKV projection of the
    MSA."""
    dist = _resolve(dist)
    b, s, r, _ = msa.shape
    dims = AttnDims(cfg.msa_heads, cfg.msa_heads, cfg.head_dim)
    z_n = layer_norm(p["ln_z"], pair)
    bias = duality.trigger(dist, "all_gather",
                           dense(p["bias"], z_n).permute(0, 3, 1, 2),
                           axis=2)                        # (B, H, r, r)
    m_n = layer_norm(p["ln_m"], msa)
    key_mask = seq_mask[:, None, :].expand(b, s, r)
    return _gated_attention(p["attn"], m_n, bias, key_mask, dims,
                            chunk=cfg.inference_chunk,
                            kv_tile=cfg.attn_kv_tile, dist=dist)


def msa_col_attention(p, msa, msa_mask, cfg: EvoformerConfig, dist=None):
    """msa (B, s, r/N, Hm) [r shard]; msa_mask (B, s, r/N)."""
    dims = AttnDims(cfg.msa_heads, cfg.msa_heads, cfg.head_dim)
    m_n = layer_norm(p["ln"], msa)
    x = m_n.transpose(1, 2)                     # (B, r/N, s, d)
    key_mask = msa_mask.transpose(1, 2)         # (B, r/N, s)
    out = _gated_attention(p["attn"], x, None, key_mask, dims,
                           chunk=cfg.inference_chunk,
                           kv_tile=cfg.attn_kv_tile, dist=dist)
    return out.transpose(1, 2)


def msa_transition(p, msa):
    return transition(p["mlp"], layer_norm(p["ln"], msa))


def outer_product_mean(p, msa, msa_mask, cfg: EvoformerConfig, dist=None):
    """msa (B, s, r/N, Hm) [r shard] -> pair update (B, r/N, r, Hz) [i
    shard]: the masked merged projection; the right half and the mask
    gathered on r (the right half across the masking of the left one); then
    the outer product, mask norm and c²→Hz projection, fused where the plan
    and the kernel's envelope allow it (with the tile ``cfg.opm_s_tile``),
    else materialized (whole, or in j blocks of ``cfg.opm_chunk``)."""
    dist = _resolve(dist)
    c = cfg.opm_dim
    m_n = layer_norm(p["ln"], msa)
    ab = dense(p["proj"], m_n)                   # merged GEMM (B, s, r/N, 2c)
    a, bproj = torch.chunk(ab, 2, dim=-1)
    mask = msa_mask[..., None].to(a.dtype)
    b_full = duality.trigger(dist, "all_gather", bproj * mask, axis=2)
    mask_full = dist.all_gather(msa_mask, axis=2)          # (B, s, r)
    a = duality.mark(a, "opm_left") * mask
    b_full = duality.block(b_full)                         # (B, s, r, c)
    if (ops.fused_opm_supported(c, p["out"]["w"].shape[1], a.dtype, a.device)
            and dist.sharded_opm_supported(a.shape[2])):
        return dist.sharded_opm(a, b_full, msa_mask, mask_full,
                                p["out"]["w"], p["out"]["b"],
                                tile=cfg.opm_s_tile)

    def opm_block(b_blk, mask_blk):
        # repro-lint: disable=R004 -- sanctioned j-chunked OPM baseline
        o = torch.einsum("bsic,bsjd->bijcd", a, b_blk)     # (B, r/N, jc, c, c)
        norm = torch.einsum("bsi,bsj->bij", msa_mask,
                            mask_blk)  # repro-lint: disable=R004
        o = (o.float() / (norm[..., None, None] + 1e-3)).to(a.dtype)
        return dense(p["out"], o.reshape(o.shape[:3] + (c * c,)))

    jc, r = cfg.opm_chunk, b_full.shape[2]
    if not jc or r % jc != 0 or jc >= r:
        return opm_block(b_full, mask_full)
    # j-chunked: the (B, r/N, jc, c*c) outer product one block at a time.
    return torch.cat([opm_block(b_full[:, :, j:j + jc],
                                mask_full[:, :, j:j + jc])
                      for j in range(0, r, jc)], dim=2)


def triangle_mult_core(p, z_src, pair_mask, tile: int = 0, dist=None):
    """The gated triangular multiplicative update in ``z_src`` coords
    (already LN'ed; rows sharded under DAP). Fused branch: the b half is
    gated and masked here and gathered on its row axis, across the output
    gate's projection; the a half's gating, the k-product, the output LN,
    projection and gate run in one op (``dist.sharded_triangle``), with the
    tile ``tile`` (``cfg.tri_k_tile``). Materialized branch (by the plan, or
    a width outside the kernel's envelope): the gated a and b, b gathered,
    the (B, r/N, r, c) product, the output LN, the projection and the gate,
    one after another."""
    dist = _resolve(dist)
    ab = dense(p["proj"], z_src)                 # (B, r/N, k, 2c) merged
    g = dense(p["gate"], z_src)
    if not (ops.fused_triangle_supported(ab.shape[-1] // 2,
                                         p["out"]["w"].shape[1], ab.dtype,
                                         ab.device)
            and dist.sharded_triangle_supported(ab.shape[1])):
        ab = ab * torch.sigmoid(g.float()).to(ab.dtype)
        ab = ab * pair_mask[..., None].to(ab.dtype)
        a, bm = torch.chunk(ab, 2, dim=-1)
        b_full = duality.trigger(dist, "all_gather", bm, axis=1)
        g_lin = (duality.mark(z_src, "tri_left")
                 @ p["gate_out"]["w"].to(z_src.dtype))
        # repro-lint: disable=R004 -- sanctioned materialized triangle A/B path
        o = torch.einsum("bikc,bjkc->bijc", a,
                         duality.block(b_full))             # (B, r/N, r, c)
        upd = dense(p["out"], layer_norm(p["ln_out"], o))
        return ops.bias_sigmoid_mul(g_lin, p["gate_out"]["b"], upd)
    a_lin, b_lin = torch.chunk(ab, 2, dim=-1)
    ga, gb = torch.chunk(g, 2, dim=-1)
    bm = (b_lin.float() * torch.sigmoid(gb.float())).to(ab.dtype)
    bm = bm * pair_mask[..., None].to(ab.dtype)
    b_full = duality.trigger(dist, "all_gather", bm, axis=1)   # (B, r, k, c)
    del bm
    g_lin = duality.mark(z_src, "tri_left") @ p["gate_out"]["w"].to(
        z_src.dtype)
    return dist.sharded_triangle(
        a_lin, ga, pair_mask, duality.block(b_full), p["ln_out"]["gamma"],
        p["ln_out"]["beta"], p["out"]["w"], p["out"]["b"], g_lin,
        p["gate_out"]["b"], tile=tile)


def triangle_mult_outgoing(p, pair, pair_mask,
                           cfg: EvoformerConfig | None = None, dist=None):
    return triangle_mult_core(p, layer_norm(p["ln_in"], pair), pair_mask,
                              tile=cfg.tri_k_tile if cfg is not None else 0,
                              dist=dist)


def triangle_mult_incoming(p, pair_t, pair_mask_t,
                           cfg: EvoformerConfig | None = None, dist=None):
    """incoming(z)_ij = sum_k a_ki b_kj == outgoing_core(z^T)_ij: computed in
    transposed coords (``pair_t`` (B, j/N, i, Hz), the all-to-all
    transposed pair) and swapped back."""
    z_n_t = layer_norm(p["ln_in"], pair_t)
    return transpose_pair(triangle_mult_core(
        p, z_n_t, pair_mask_t, tile=cfg.tri_k_tile if cfg is not None else 0,
        dist=dist), dist)


def triangle_attention(p, pair, seq_mask, cfg: EvoformerConfig, dist=None):
    """Around the starting node on (B, r/N, r, Hz) [i shard]: per-row
    attention over k with bias b(j, k), projected from the local rows and
    gathered across the QKV projection."""
    dist = _resolve(dist)
    b, r_i, r, _ = pair.shape
    dims = AttnDims(cfg.pair_heads, cfg.pair_heads, cfg.head_dim)
    z_n = layer_norm(p["ln"], pair)
    bias = duality.trigger(dist, "all_gather",
                           dense(p["bias"], z_n).permute(0, 3, 1, 2),
                           axis=2)                        # (B, H, r, r)
    key_mask = seq_mask[:, None, :].expand(b, r_i, r)
    return _gated_attention(p["attn"], z_n, bias, key_mask, dims,
                            chunk=cfg.inference_chunk,
                            kv_tile=cfg.attn_kv_tile, dist=dist)


# ---------------------------------------------------------------------------
# Block and stack
# ---------------------------------------------------------------------------

def evoformer_block(params: Params, msa: torch.Tensor, pair: torch.Tensor,
                    msa_mask: torch.Tensor, seq_mask: torch.Tensor,
                    pair_mask: torch.Tensor, *, cfg: EvoformerConfig,
                    keeps: dict | None = None, dist=None):
    """One Evoformer block: msa (B, s/N, r, Hm) [s shard], pair
    (B, r/N, r, Hz) [i shard], masks msa_mask (B, s/N, r), seq_mask (B, r)
    whole, pair_mask (B, r/N, r); N = 1 on one device. ``keeps``: the
    block's dropout masks by site (``DROPOUT_SITES``), already the rank's
    shards, or None for none. ``dist=None`` resolves the current plan's
    ``ParallelPolicy``."""
    dist = _resolve(dist)
    kp = keeps or {}
    rm, rz = cfg.dropout_msa, cfg.dropout_pair
    # Each update goes straight into its residual add, so none is still
    # held while the next site runs.
    msa = _residual_add(
        msa_row_attention(params["msa_row"], msa, pair, seq_mask, cfg,
                          dist=dist), msa, rm, kp.get("msa_row"))
    # All-to-all #1: s shard -> r shard, the MSA and its mask.
    msa = dist.all_to_all(msa, split_axis=2, concat_axis=1)
    msa_mask_r = dist.all_to_all(msa_mask, split_axis=2, concat_axis=1)
    msa = _residual_add(
        msa_col_attention(params["msa_col"], msa, msa_mask_r, cfg,
                          dist=dist), msa)
    msa = _residual_add(msa_transition(params["msa_trans"], msa), msa)

    pair_upd = outer_product_mean(params["opm"], msa, msa_mask_r, cfg,
                                  dist=dist)
    # All-to-all #2, the Duality-Async window: the MSA goes back to the s
    # shard while the whole pair stack runs; blocked at the block's end.
    msa = duality.trigger(dist, "all_to_all", msa, split_axis=1,
                          concat_axis=2)
    pair = _residual_add(pair_upd, pair, rz, kp.get("opm"))
    del pair_upd
    pair = duality.mark(pair, "tri_mult_out")
    pair = _residual_add(
        triangle_mult_outgoing(params["tri_mult_out"], pair, pair_mask, cfg,
                               dist=dist),
        pair, rz, kp.get("tri_mult_out"))
    pair = duality.mark(pair, "tri_mult_in")
    pair = _residual_add(
        triangle_mult_incoming(params["tri_mult_in"],
                               transpose_pair(pair, dist),
                               transpose_pair(pair_mask, dist), cfg,
                               dist=dist),
        pair, rz, kp.get("tri_mult_in"))
    pair = duality.mark(pair, "tri_attn_start")
    pair = _residual_add(
        triangle_attention(params["tri_attn_start"], pair, seq_mask, cfg,
                           dist=dist),
        pair, rz, kp.get("tri_attn_start"))
    # Ending-node attention == starting-node attention on the transpose.
    pair = duality.mark(pair, "tri_attn_end")
    pair = _residual_add(
        transpose_pair(triangle_attention(
            params["tri_attn_end"], transpose_pair(pair, dist), seq_mask, cfg,
            dist=dist), dist),
        pair, rz, kp.get("tri_attn_end"))
    pair = duality.mark(pair, "pair_trans")
    pair = _residual_add(
        transition(params["pair_trans"]["mlp"],
                   layer_norm(params["pair_trans"]["ln"], pair)), pair)
    return duality.block(msa), pair


# The aten matrix products whose outputs the "dots" policy keeps: the
# reference's ``dots_saveable`` keeps every ``dot_general``. The hand-written
# kernels launch outside the dispatcher, so, like a ``pallas_call`` under
# ``dots_saveable``, they are recomputed; so is every other aten op,
# including the allocation of a kernel's output.
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default,
                   torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


# remat_policy -> the checkpoint's context_fn.
REMAT_CONTEXTS = {"nothing": noop_context_fn, "dots": _dots_contexts}


def local_keeps(keeps: dict | None, dist) -> dict | None:
    """The rank's shards of one block's dropout masks, drawn whole on every
    rank: each mask is cut on axis 1 (the MSA's s, the pair's i) where it is
    not broadcast there."""
    if keeps is None:
        return None
    return {site: dist.shard(k, axis=1) if k.shape[1] > 1 else k
            for site, k in keeps.items()}


def _synced(p: Params, dist) -> Params:
    """A block's parameters through ``dist.sync_grads``: replicated on every
    rank, so each rank's gradient is a partial sum over its shard until the
    backward all-reduces them (the identity on one device)."""
    if isinstance(dist, LocalDist):
        return p
    leaves = iter(dist.sync_grads(tree_leaves(p)))
    return tree_map(lambda _: next(leaves), p)


def evoformer_stack(params: list[Params], msa: torch.Tensor,
                    pair: torch.Tensor, msa_mask: torch.Tensor,
                    seq_mask: torch.Tensor, pair_mask: torch.Tensor, *,
                    cfg: EvoformerConfig, keeps: list[dict] | None = None,
                    remat: bool = False, dist=None):
    """The n_blocks Evoformer blocks in a Python loop, on the tensors in
    hand (the rank's shards under DAP, ``evoformer_block``'s layout).
    ``keeps``: one dict of dropout masks per block, whole (each rank takes
    its shards, ``local_keeps``), or None. ``dist=None`` resolves the
    current plan's ``ParallelPolicy``; under a process group each block's
    parameters enter through ``dist.sync_grads``. ``remat``: when a graph is
    being built, each block runs again in the backward (activation
    checkpointing per block, the reference's ``remat=True``). Under
    ``cfg.remat_policy`` "nothing" a block keeps only its inputs; under
    "dots" it also keeps the outputs of its matrix products (a selective
    checkpoint), which the recompute takes instead of running them again.
    Either way the recompute runs every kernel of the block a second time.
    It runs under the plan and the ``dist`` the forward ran under, which
    the backward's thread does not see unless the block re-enters them, so
    it takes the forward's branches, makes the same products in the same
    order and launches the same collectives. An unknown policy raises
    ValueError."""
    if cfg.remat_policy not in REMAT_CONTEXTS:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: not one of "
                         f"{sorted(REMAT_CONTEXTS)}")
    context_fn = REMAT_CONTEXTS[cfg.remat_policy]
    plan = current_plan()
    dist = _resolve(dist)

    def block_under_plan(*args, **kw):
        with use_plan(plan):
            return evoformer_block(*args, **kw)

    for i, p in enumerate(params):
        kb = local_keeps(keeps[i], dist) if keeps is not None else None
        p = _synced(p, dist)
        if remat and torch.is_grad_enabled():
            with set_checkpoint_early_stop(False):
                msa, pair = checkpoint(
                    block_under_plan, p, msa, pair, msa_mask, seq_mask,
                    pair_mask, cfg=cfg, keeps=kb, dist=dist,
                    use_reentrant=False, context_fn=context_fn)
        else:
            msa, pair = evoformer_block(p, msa, pair, msa_mask, seq_mask,
                                        pair_mask, cfg=cfg, keeps=kb,
                                        dist=dist)
    return msa, pair
