"""Evoformer (AlphaFold 2 trunk), single device, inference.

The port of the reference's ``evoformer_block`` / ``evoformer_stack`` with
single-device semantics: collectives are the identity, ``transpose_pair`` is
an axis swap, and the async overlap window is the identity. The four
attention sites (MSA row with pair bias, MSA column, triangle start and end
with pair bias) go through ``ops.fused_attention`` — the flash-attention
kernel on the card. Every LayerNorm goes through the LayerNorm kernel and
every output gate through the gating kernel. Both triangular multiplicative
updates and the outer-product-mean take the materialized paths the
reference runs under its ``triangle-oracle`` plan preset, in plain torch;
their fused kernels are not ported yet. There is no remat and no dropout:
this is the inference forward.
"""
from __future__ import annotations

import torch

from repro_torch.configs.alphafold import EvoformerConfig
from repro_torch.kernels import ops
from repro_torch.layers.attention import (AttnDims, init_attention,
                                          output_proj, project_qkv)
from repro_torch.layers.mlp import init_transition, transition
from repro_torch.layers.norms import init_layer_norm, layer_norm
from repro_torch.layers.params import Params, dense, init_dense

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

def _residual_add(upd: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Inference residual add (no dropout): fp32 add, residual's dtype."""
    return ops.bias_dropout_add(upd, None, residual)


def transpose_pair(x: torch.Tensor) -> torch.Tensor:
    """(B, i, j, ...) -> (B, j, i, ...): on one device the all_to_all of the
    reference is the identity and only the axis swap remains."""
    return x.transpose(1, 2)


def _gated_attention(p_attn: Params, x_n: torch.Tensor,
                     bias: torch.Tensor | None, key_mask: torch.Tensor,
                     dims: AttnDims) -> torch.Tensor:
    """Group attention, 5D. x_n (B, G, S, d); bias (B, H, S, S) shared
    across G, or None; key_mask (B, G, S) in {0, 1}."""
    q, k, v = project_qkv(p_attn, x_n, dims, compute_dtype=x_n.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = torch.where(key_mask > 0, 0.0, NEG_INF).to(torch.float32)
    ctx = ops.fused_attention(q, k, v, bias=bias, mask=mask, scale=scale)
    return output_proj(p_attn, ctx, x_for_gate=x_n)


# ---------------------------------------------------------------------------
# Sub-modules
# ---------------------------------------------------------------------------

def msa_row_attention(p, msa, pair, seq_mask, cfg: EvoformerConfig):
    """msa (B, s, r, Hm); pair (B, r, r, Hz); seq_mask (B, r)."""
    b, s, r, _ = msa.shape
    dims = AttnDims(cfg.msa_heads, cfg.msa_heads, cfg.head_dim)
    z_n = layer_norm(p["ln_z"], pair)
    bias = dense(p["bias"], z_n).permute(0, 3, 1, 2)     # (B, H, r, r)
    m_n = layer_norm(p["ln_m"], msa)
    key_mask = seq_mask[:, None, :].expand(b, s, r)
    return _gated_attention(p["attn"], m_n, bias, key_mask, dims)


def msa_col_attention(p, msa, msa_mask, cfg: EvoformerConfig):
    """msa (B, s, r, Hm); msa_mask (B, s, r)."""
    dims = AttnDims(cfg.msa_heads, cfg.msa_heads, cfg.head_dim)
    m_n = layer_norm(p["ln"], msa)
    x = m_n.transpose(1, 2)                     # (B, r, s, d)
    key_mask = msa_mask.transpose(1, 2)         # (B, r, s)
    out = _gated_attention(p["attn"], x, None, key_mask, dims)
    return out.transpose(1, 2)


def msa_transition(p, msa):
    return transition(p["mlp"], layer_norm(p["ln"], msa))


def outer_product_mean(p, msa, msa_mask, cfg: EvoformerConfig):
    """msa (B, s, r, Hm) -> pair update (B, r, r, Hz), materialized: the
    (B, r, r, c, c) outer product is a whole tensor."""
    c = cfg.opm_dim
    m_n = layer_norm(p["ln"], msa)
    ab = dense(p["proj"], m_n)                   # merged GEMM (B, s, r, 2c)
    a, bproj = torch.chunk(ab, 2, dim=-1)
    mask = msa_mask[..., None].to(a.dtype)
    a = a * mask
    bproj = bproj * mask
    o = torch.einsum("bsic,bsjd->bijcd", a, bproj)           # (B, r, r, c, c)
    norm = torch.einsum("bsi,bsj->bij", msa_mask, msa_mask)
    o = (o.float() / (norm[..., None, None] + 1e-3)).to(a.dtype)
    o = o.reshape(o.shape[:3] + (c * c,))
    return dense(p["out"], o)                    # (B, r, r, Hz)


def triangle_mult_core(p, z_src, pair_mask):
    """The gated triangular multiplicative update in ``z_src`` coords,
    materialized: gated projections and the (B, r, r, c) product as whole
    tensors, then LN -> projection -> output gate."""
    ab = dense(p["proj"], z_src)                 # (B, r, k, 2c) merged
    g = dense(p["gate"], z_src)
    g_lin = z_src @ p["gate_out"]["w"].to(z_src.dtype)
    ab = ab * torch.sigmoid(g.float()).to(ab.dtype)
    ab = ab * pair_mask[..., None].to(ab.dtype)
    a, bm = torch.chunk(ab, 2, dim=-1)
    o = torch.einsum("bikc,bjkc->bijc", a, bm)   # (B, r, r, c)
    upd = dense(p["out"], layer_norm(p["ln_out"], o))
    return ops.bias_sigmoid_mul(g_lin, p["gate_out"]["b"], upd)


def triangle_mult_outgoing(p, pair, pair_mask):
    return triangle_mult_core(p, layer_norm(p["ln_in"], pair), pair_mask)


def triangle_mult_incoming(p, pair_t, pair_mask_t):
    """incoming(z)_ij = sum_k a_ki b_kj == outgoing_core(z^T)_ij: computed in
    transposed coords and swapped back."""
    z_n_t = layer_norm(p["ln_in"], pair_t)
    return transpose_pair(triangle_mult_core(p, z_n_t, pair_mask_t))


def triangle_attention(p, pair, seq_mask, cfg: EvoformerConfig):
    """Around the starting node on (B, i, j, Hz): per-row attention over k
    with bias b(j, k)."""
    b, r_i, r, _ = pair.shape
    dims = AttnDims(cfg.pair_heads, cfg.pair_heads, cfg.head_dim)
    z_n = layer_norm(p["ln"], pair)
    bias = dense(p["bias"], z_n).permute(0, 3, 1, 2)       # (B, H, r, r)
    key_mask = seq_mask[:, None, :].expand(b, r_i, r)
    return _gated_attention(p["attn"], z_n, bias, key_mask, dims)


# ---------------------------------------------------------------------------
# Block and stack
# ---------------------------------------------------------------------------

def evoformer_block(params: Params, msa: torch.Tensor, pair: torch.Tensor,
                    msa_mask: torch.Tensor, seq_mask: torch.Tensor,
                    pair_mask: torch.Tensor, *, cfg: EvoformerConfig):
    """One Evoformer block: msa (B, s, r, Hm), pair (B, r, r, Hz), masks
    msa_mask (B, s, r), seq_mask (B, r), pair_mask (B, r, r)."""
    upd = msa_row_attention(params["msa_row"], msa, pair, seq_mask, cfg)
    msa = _residual_add(upd, msa)
    upd = msa_col_attention(params["msa_col"], msa, msa_mask, cfg)
    msa = _residual_add(upd, msa)
    msa = _residual_add(msa_transition(params["msa_trans"], msa), msa)

    pair = _residual_add(outer_product_mean(params["opm"], msa, msa_mask, cfg),
                         pair)
    upd = triangle_mult_outgoing(params["tri_mult_out"], pair, pair_mask)
    pair = _residual_add(upd, pair)
    upd = triangle_mult_incoming(params["tri_mult_in"], transpose_pair(pair),
                                 transpose_pair(pair_mask))
    pair = _residual_add(upd, pair)
    upd = triangle_attention(params["tri_attn_start"], pair, seq_mask, cfg)
    pair = _residual_add(upd, pair)
    # Ending-node attention == starting-node attention on the transpose.
    upd_t = triangle_attention(params["tri_attn_end"], transpose_pair(pair),
                               seq_mask, cfg)
    pair = _residual_add(transpose_pair(upd_t), pair)
    pair = _residual_add(
        transition(params["pair_trans"]["mlp"],
                   layer_norm(params["pair_trans"]["ln"], pair)), pair)
    return msa, pair


def evoformer_stack(params: list[Params], msa: torch.Tensor,
                    pair: torch.Tensor, msa_mask: torch.Tensor,
                    seq_mask: torch.Tensor, pair_mask: torch.Tensor, *,
                    cfg: EvoformerConfig):
    """The n_blocks Evoformer blocks in a Python loop."""
    for p in params:
        msa, pair = evoformer_block(p, msa, pair, msa_mask, seq_mask,
                                    pair_mask, cfg=cfg)
    return msa, pair
