"""AlphaFold-2 as FastFold runs it, in plain fp32 PyTorch: the embedders,
recycling, the Evoformer, the structure module, the heads and the
training loss.

This is the benchmark's yardstick for what the port computes. It imports
nothing of the program and uses no kernel: every product is a ``matmul``
or ``einsum`` and every normalisation is written out. Parameters are the
nested dicts ``param_shapes`` lays out (the Evoformer's blocks a list), so
the same seeded tree is handed to the program and to this model.

Three hooks serve the harness:

* ``Precision``: the operands of every product that the configuration runs
  in its compute dtype are rounded through it. ``Precision("fp32")`` leaves
  them alone (the reference); ``Precision("fp8")`` rounds them to
  float8_e4m3 with one scale a tensor, and under its ``products()`` the
  products the program runs in fp32 run in TF32 on a card (the control
  that a lower precision than the configuration's has to fail).
* ``Sites``: where the program runs a hand-written kernel, the model notes
  the kernel's work formula and the shapes of its operands and results,
  once per site, at the dtype the program holds them in. The cost
  arithmetic (``reference.costs``) turns them into bound times.
* ``row_bytes``: the largest temporary a chunked op may make. Attention,
  the outer product mean and the transitions run in blocks of rows that
  fit under it, so r = 2048 fits on one card; blocks change no number
  beyond the order of fp32 sums.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

N_AA = 21
N_MSA_TOK = 23
RELPOS_K = 32
N_DIST_BINS = 64
NEG_INF = -1e9
# The six residual adds that apply dropout, with the axis of the update that
# shares one draw, in the order the masks are drawn.
DROPOUT_SITES = {"msa_row": 2, "opm": 1, "tri_mult_out": 1, "tri_mult_in": 1,
                 "tri_attn_start": 1, "tri_attn_end": 2}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclass(frozen=True)
class Dims:
    """The sizes a configuration file states (``configs/*.json``)."""
    d_msa: int
    d_pair: int
    msa_heads: int
    pair_heads: int
    head_dim: int
    opm_dim: int
    tri_mult_dim: int
    transition_factor: int
    dropout_msa: float
    dropout_pair: float
    n_blocks: int
    c_s: int
    ipa_heads: int
    ipa_c_hidden: int
    n_qk_points: int
    n_v_points: int
    n_iterations: int
    trans_scale: float
    n_recycle: int
    recycle_bins: int
    compute_dtype: str

    @classmethod
    def from_config(cls, cfg: dict) -> "Dims":
        return cls(**{f: cfg[f] for f in cls.__dataclass_fields__})

    @property
    def act_bytes(self) -> int:
        return DTYPE_BYTES[self.compute_dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _dense(d_in, d_out, bias=True):
    p = {"w": (d_in, d_out)}
    if bias:
        p["b"] = (d_out,)
    return p


def _ln(d):
    return {"gamma": (d,), "beta": (d,)}


def _attention(d_in, heads, hd, d_out):
    return {"wqkv": _dense(d_in, 3 * heads * hd, bias=False),
            "wo": _dense(heads * hd, d_out),
            "wg": _dense(d_in, heads * hd)}


def param_shapes(d: Dims) -> dict:
    """The parameter tree, as shapes: nested dicts, the Evoformer's blocks a
    list of ``n_blocks`` dicts."""
    dm, dz, hd = d.d_msa, d.d_pair, d.head_dim
    c = d.tri_mult_dim

    def tri_mult():
        return {"ln_in": _ln(dz), "proj": _dense(dz, 2 * c),
                "gate": _dense(dz, 2 * c), "ln_out": _ln(c),
                "out": _dense(c, dz), "gate_out": _dense(dz, dz)}

    def tri_attn():
        return {"ln": _ln(dz), "bias": _dense(dz, d.pair_heads, bias=False),
                "attn": _attention(dz, d.pair_heads, hd, dz)}

    def transition(x):
        f = d.transition_factor
        return {"ln": _ln(x), "mlp": {"wi": _dense(x, f * x),
                                      "wo": _dense(f * x, x)}}

    block = {
        "msa_row": {"ln_m": _ln(dm), "ln_z": _ln(dz),
                    "bias": _dense(dz, d.msa_heads, bias=False),
                    "attn": _attention(dm, d.msa_heads, hd, dm)},
        "msa_col": {"ln": _ln(dm), "attn": _attention(dm, d.msa_heads, hd, dm)},
        "msa_trans": transition(dm),
        "opm": {"ln": _ln(dm), "proj": _dense(dm, 2 * d.opm_dim),
                "out": _dense(d.opm_dim * d.opm_dim, dz)},
        "tri_mult_out": tri_mult(),
        "tri_mult_in": tri_mult(),
        "tri_attn_start": tri_attn(),
        "tri_attn_end": tri_attn(),
        "pair_trans": transition(dz),
    }
    h, ch, qp, vp = d.ipa_heads, d.ipa_c_hidden, d.n_qk_points, d.n_v_points
    cs = d.c_s
    structure = {
        "ln_s": _ln(cs), "ln_z": _ln(dz), "proj_s": _dense(cs, cs, bias=False),
        "ipa": {"q": _dense(cs, h * ch, bias=False),
                "kv": _dense(cs, 2 * h * ch, bias=False),
                "q_pts": _dense(cs, h * qp * 3, bias=False),
                "kv_pts": _dense(cs, h * (qp + vp) * 3, bias=False),
                "bias_z": _dense(dz, h, bias=False),
                "head_w": (h,),
                "out": _dense(h * ch + h * dz + h * vp * 4, cs)},
        "ln_ipa": _ln(cs), "trans1": _dense(cs, cs), "trans2": _dense(cs, cs),
        "trans3": _dense(cs, cs), "ln_trans": _ln(cs),
        "bb_update": _dense(cs, 6),
    }
    return {
        "msa_embed": _dense(N_MSA_TOK, dm), "target_embed_m": _dense(N_AA, dm),
        "left_embed": _dense(N_AA, dz), "right_embed": _dense(N_AA, dz),
        "relpos_embed": _dense(2 * RELPOS_K + 1, dz),
        "recycle": {"ln_m": _ln(dm), "ln_z": _ln(dz),
                    "dist_embed": _dense(d.recycle_bins, dz)},
        "evoformer": [block] * d.n_blocks,
        "single_proj": _dense(dm, cs),
        "structure": structure,
        "msa_head": _dense(dm, N_MSA_TOK),
        "dist_head": _dense(dz, N_DIST_BINS),
    }


def leaves(tree, path=()):
    """(path, leaf) pairs in a fixed order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from leaves(t, path + (i,))
    else:
        yield path, tree


def rebuild(tree, values):
    """A tree of ``tree``'s structure whose leaves are ``values`` taken in
    ``leaves`` order."""
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(t) for t in node]
        return next(it)

    return walk(tree)


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------

class Precision:
    """Rounding of the operands of products run in the compute dtype:
    ``fp32`` none, ``fp8`` to float8_e4m3 with a per-tensor scale (the
    largest magnitude onto 448), straight through for the gradient; with
    ``fp8`` the fp32 products also drop a step, to TF32, inside
    ``products()``."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: fp32 or fp8")
        self.kind = kind

    @contextlib.contextmanager
    def products(self):
        """Run what follows with the card's fp32 products in TF32 for
        ``fp8`` and in full fp32 for ``fp32``."""
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = cuda.allow_tf32, cudnn.allow_tf32
        cuda.allow_tf32 = cudnn.allow_tf32 = self.kind != "fp32"
        try:
            yield
        finally:
            cuda.allow_tf32, cudnn.allow_tf32 = saved

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32" or x.device.type == "meta":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())


class Sites:
    """The kernel sites a run passes, as ``(work, dims)``: ``work`` names a
    formula of ``reference.costs``, ``dims`` its sizes and byte widths."""

    def __init__(self):
        self.calls: list[tuple[str, dict]] = []

    def add(self, work: str, **dims) -> None:
        self.calls.append((work, dims))


def _rows_per_block(total: int, row_bytes: int, budget: int) -> int:
    return max(1, min(total, budget // max(1, row_bytes)))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class AlphaFold:
    """The fp32 model of one configuration, with its hooks."""

    def __init__(self, dims: Dims, precision: Precision | None = None,
                 sites: Sites | None = None, row_bytes: int = 1 << 30):
        self.d = dims
        self.q = precision or Precision("fp32")
        self.sites = sites
        self.row_bytes = row_bytes
        self.grad_pass = False

    # -- primitives --------------------------------------------------------

    def _site(self, work, **dims):
        if self.sites is not None:
            self.sites.add(work, **dims)

    def dense(self, p, x, low=True):
        """x @ w + b; ``low``: the product runs in the compute dtype in the
        program, so its operands go through the precision hook."""
        q = self.q if low else (lambda t: t)
        y = q(x) @ q(p["w"])
        return y + p["b"] if "b" in p else y

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    def layer_norm(self, p, x, act_bytes, eps=1e-5):
        self._site("layer_norm", n=x.numel(), c=x.shape[-1],
                   x_bytes=act_bytes)
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]

    def residual(self, upd, residual, rate=0.0, keep=None):
        if keep is not None and rate > 0.0:
            self._site("bias_dropout_add", n=upd.numel(),
                       keep=keep.numel(), x_bytes=self.d.act_bytes)
            upd = upd * keep / (1.0 - rate)
        return residual + upd

    # -- attention ---------------------------------------------------------

    def gated_attention(self, p, x, bias, key_mask, heads):
        """x (B, G, S, d); bias (B, H, S, S) shared across G, or None;
        key_mask (B, G, S) in {0, 1}. Runs in blocks of G."""
        b, g, s, _ = x.shape
        hd = self.d.head_dim
        ab = self.d.act_bytes
        self._site("attention_fwd", n=b * g, sq=s, skv=s, h=heads, d=hd,
                   bias=0 if bias is None else b * heads * s * s,
                   x_bytes=ab)
        if self.grad_pass:
            self._site("attention_bwd", n=b * g, sq=s, skv=s, h=heads, d=hd,
                       bias=0 if bias is None else b * heads * s * s,
                       x_bytes=ab)
        self._site("bias_sigmoid_mul", n=b * g * s * heads * hd,
                   c=heads * hd, x_bytes=ab)
        scale = 1.0 / math.sqrt(hd)
        step = _rows_per_block(g, 3 * heads * s * s * 4, self.row_bytes)
        outs = []
        for g0 in range(0, g, step):
            xc = x[:, g0:g0 + step]
            y = self.dense(p["wqkv"], xc)
            qh, kh, vh = (t.unflatten(-1, (heads, hd))
                          for t in torch.split(y, heads * hd, dim=-1))
            scores = self.einsum("bgihd,bgjhd->bghij", qh, kh) * scale
            if bias is not None:
                scores = scores + bias[:, None]
            mask = torch.where(key_mask[:, g0:g0 + step] > 0, 0.0, NEG_INF)
            scores = scores + mask[:, :, None, None, :]
            probs = torch.softmax(scores, dim=-1)
            ctx = self.einsum("bghij,bgjhd->bgihd", probs, vh).flatten(-2)
            gate = torch.sigmoid(self.dense(p["wg"], xc))
            outs.append(self.dense(p["wo"], gate * ctx))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    # -- Evoformer sub-modules ---------------------------------------------

    def msa_row_attention(self, p, msa, pair, seq_mask):
        b, s, r, _ = msa.shape
        z_n = self.layer_norm(p["ln_z"], pair, self.d.act_bytes)
        bias = self.dense(p["bias"], z_n).permute(0, 3, 1, 2)
        m_n = self.layer_norm(p["ln_m"], msa, self.d.act_bytes)
        key_mask = seq_mask[:, None, :].expand(b, s, r)
        return self.gated_attention(p["attn"], m_n, bias, key_mask,
                                    self.d.msa_heads)

    def msa_col_attention(self, p, msa, msa_mask):
        m_n = self.layer_norm(p["ln"], msa, self.d.act_bytes)
        out = self.gated_attention(p["attn"], m_n.transpose(1, 2), None,
                                   msa_mask.transpose(1, 2),
                                   self.d.msa_heads)
        return out.transpose(1, 2)

    def transition(self, p, x):
        """LN -> Linear(f x) -> ReLU -> Linear, in blocks of axis-1 rows."""
        x_n = self.layer_norm(p["ln"], x, self.d.act_bytes)
        per_row = x_n[0, 0].numel() * self.d.transition_factor * 4 * x.shape[0]
        step = _rows_per_block(x.shape[1], per_row, self.row_bytes)
        outs = [self.dense(p["mlp"]["wo"], torch.relu(
            self.dense(p["mlp"]["wi"], x_n[:, i:i + step])))
            for i in range(0, x.shape[1], step)]
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def outer_product_mean(self, p, msa, msa_mask):
        b, s, r, _ = msa.shape
        c = self.d.opm_dim
        m_n = self.layer_norm(p["ln"], msa, self.d.act_bytes)
        ab = self.dense(p["proj"], m_n)
        a, bb = torch.chunk(ab, 2, dim=-1)
        mask = msa_mask[..., None]
        a = a * mask
        bb = bb * mask
        self._site("outer_product_mean", b=b, s=s, i=r, j=r, c=c,
                   dz=self.d.d_pair, x_bytes=self.d.act_bytes)
        step = _rows_per_block(r, b * r * c * c * 4 * 2, self.row_bytes)
        outs = []
        for i in range(0, r, step):
            o = self.einsum("bsic,bsjd->bijcd", a[:, :, i:i + step], bb)
            norm = torch.einsum("bsi,bsj->bij", msa_mask[:, :, i:i + step],
                                msa_mask)
            o = o / (norm[..., None, None] + 1e-3)
            outs.append(self.dense(p["out"], o.flatten(-2)))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def triangle_mult_core(self, p, z, pair_mask):
        """The outgoing update of ``z`` (B, I, K, c_z), gated and masked:
        out_ij = gate_ij * (LN(sum_k a_ik b_jk) @ w + b)."""
        b, ni, nk, _ = z.shape
        c = self.d.tri_mult_dim
        z_n = self.layer_norm(p["ln_in"], z, self.d.act_bytes)
        ab = self.dense(p["proj"], z_n) * torch.sigmoid(
            self.dense(p["gate"], z_n))
        ab = ab * pair_mask[..., None]
        a, bb = torch.chunk(ab, 2, dim=-1)
        self._site("triangle_mult", b=b, i=ni, j=nk, k=nk, c=c,
                   dz=self.d.d_pair, x_bytes=self.d.act_bytes)
        o = self.einsum("bikc,bjkc->bijc", a, bb)
        mean = o.mean(dim=-1, keepdim=True)
        var = (o - mean).square().mean(dim=-1, keepdim=True)
        y = ((o - mean) * torch.rsqrt(var + 1e-5) * p["ln_out"]["gamma"]
             + p["ln_out"]["beta"])
        upd = self.dense(p["out"], y)
        gate = torch.sigmoid(self.q(z_n) @ self.q(p["gate_out"]["w"])
                             + p["gate_out"]["b"])
        return gate * upd

    def triangle_attention(self, p, pair, seq_mask):
        b, ni, r, _ = pair.shape
        z_n = self.layer_norm(p["ln"], pair, self.d.act_bytes)
        bias = self.dense(p["bias"], z_n).permute(0, 3, 1, 2)
        key_mask = seq_mask[:, None, :].expand(b, ni, r)
        return self.gated_attention(p["attn"], z_n, bias, key_mask,
                                    self.d.pair_heads)

    def evoformer_block(self, p, msa, pair, msa_mask, seq_mask, pair_mask,
                        keeps=None):
        kp = keeps or {}
        rm, rz = self.d.dropout_msa, self.d.dropout_pair
        msa = self.residual(self.msa_row_attention(p["msa_row"], msa, pair,
                                                   seq_mask),
                            msa, rm, kp.get("msa_row"))
        msa = self.residual(self.msa_col_attention(p["msa_col"], msa,
                                                   msa_mask), msa)
        msa = self.residual(self.transition(p["msa_trans"], msa), msa)
        pair = self.residual(self.outer_product_mean(p["opm"], msa, msa_mask),
                             pair, rz, kp.get("opm"))
        pair = self.residual(self.triangle_mult_core(p["tri_mult_out"], pair,
                                                     pair_mask),
                             pair, rz, kp.get("tri_mult_out"))
        pair = self.residual(self.triangle_mult_core(
            p["tri_mult_in"], pair.transpose(1, 2),
            pair_mask.transpose(1, 2)).transpose(1, 2),
            pair, rz, kp.get("tri_mult_in"))
        pair = self.residual(self.triangle_attention(p["tri_attn_start"],
                                                     pair, seq_mask),
                             pair, rz, kp.get("tri_attn_start"))
        pair = self.residual(self.triangle_attention(
            p["tri_attn_end"], pair.transpose(1, 2), seq_mask).transpose(1, 2),
            pair, rz, kp.get("tri_attn_end"))
        pair = self.residual(self.transition(p["pair_trans"], pair), pair)
        return msa, pair

    def evoformer(self, blocks, msa, pair, msa_mask, seq_mask, pair_mask,
                  keeps=None, remat=False):
        for i, p in enumerate(blocks):
            kb = keeps[i] if keeps is not None else None
            if remat and torch.is_grad_enabled():
                msa, pair = checkpoint(self.evoformer_block, p, msa, pair,
                                       msa_mask, seq_mask, pair_mask, kb,
                                       use_reentrant=False)
            else:
                msa, pair = self.evoformer_block(p, msa, pair, msa_mask,
                                                 seq_mask, pair_mask, kb)
        return msa, pair

    # -- embedding, structure module, heads --------------------------------

    @staticmethod
    def one_hot(x, n):
        return (x[..., None] == torch.arange(n, device=x.device)).float()

    def embed(self, p, batch, prev):
        msa = self.dense(p["msa_embed"], self.one_hot(batch["msa"], N_MSA_TOK))
        aa = self.one_hot(batch["aatype"], N_AA)
        msa = msa + self.dense(p["target_embed_m"], aa)[:, None]
        pair = (self.dense(p["left_embed"], aa)[:, :, None]
                + self.dense(p["right_embed"], aa)[:, None])
        ri = batch["residue_index"]
        rel = torch.clamp(ri[:, :, None] - ri[:, None, :], -RELPOS_K,
                          RELPOS_K) + RELPOS_K
        pair = pair + self.dense(p["relpos_embed"],
                                 self.one_hot(rel, 2 * RELPOS_K + 1))
        prev_m, prev_z, prev_pos = prev
        rc = p["recycle"]
        row0 = msa[:, :1] + self.layer_norm(rc["ln_m"], prev_m, 4)[:, None]
        msa = torch.cat([row0, msa[:, 1:]], dim=1)
        pair = pair + self.layer_norm(rc["ln_z"], prev_z, 4)
        dist = torch.linalg.norm(prev_pos[:, :, None] - prev_pos[:, None]
                                 + 1e-8, dim=-1)
        edges = torch.linspace(3.375, 21.375, self.d.recycle_bins - 1,
                               device=dist.device)
        bins = torch.sum(dist[..., None] > edges, dim=-1)
        pair = pair + self.dense(rc["dist_embed"],
                                 self.one_hot(bins, self.d.recycle_bins))
        return msa, pair

    def ipa(self, p, s, z, rot, trans, seq_mask):
        b, r, _ = s.shape
        h, c = self.d.ipa_heads, self.d.ipa_c_hidden
        qp, vp = self.d.n_qk_points, self.d.n_v_points
        f32 = lambda pp, x: self.dense(pp, x, low=False)  # noqa: E731
        q = f32(p["q"], s).reshape(b, r, h, c)
        k, v = torch.chunk(f32(p["kv"], s).reshape(b, r, h, 2 * c), 2, dim=-1)
        q_pts = f32(p["q_pts"], s).reshape(b, r, h * qp, 3)
        kv_pts = f32(p["kv_pts"], s).reshape(b, r, h * (qp + vp), 3)
        q_pts = (torch.einsum("bixy,bipy->bipx", rot, q_pts)
                 + trans[:, :, None]).reshape(b, r, h, qp, 3)
        kv_pts = torch.einsum("bixy,bipy->bipx", rot, kv_pts) + trans[:, :, None]
        k_pts, v_pts = torch.split(kv_pts.reshape(b, r, h, qp + vp, 3),
                                   [qp, vp], dim=-2)
        logits = torch.einsum("bihc,bjhc->bhij", q, k) / math.sqrt(3 * c)
        logits = logits + f32(p["bias_z"], z).permute(0, 3, 1, 2) / math.sqrt(3.0)
        d2 = torch.sum(torch.square(q_pts[:, :, None] - k_pts[:, None]), dim=-1)
        w_pt = (F.softplus(p["head_w"]) / math.sqrt(3.0)
                * math.sqrt(9.0 / (2 * qp)) * 0.5)
        logits = logits - torch.einsum("bijhp,h->bhij", d2, w_pt)
        logits = torch.where(seq_mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, NEG_INF))
        attn = torch.softmax(logits, dim=-1)
        o_scalar = torch.einsum("bhij,bjhc->bihc", attn, v).reshape(b, r, h * c)
        o_pair = torch.einsum("bhij,bijc->bihc", attn, z).reshape(
            b, r, h * z.shape[-1])
        o_pts = torch.einsum("bhij,bjhpx->bihpx", attn, v_pts).reshape(
            b, r, h * vp, 3)
        local = torch.einsum("biyx,bipy->bipx", rot, o_pts - trans[:, :, None])
        norm = torch.linalg.norm(local + 1e-8, dim=-1, keepdim=True)
        feats = torch.cat([local, norm], dim=-1).reshape(b, r, h * vp * 4)
        return f32(p["out"], torch.cat([o_scalar, o_pair, feats], dim=-1))

    @staticmethod
    def quat_to_rot(q):
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
        w, x, y, z = q.unbind(-1)
        return torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1)], dim=-2)

    def structure(self, p, s_init, z, seq_mask):
        """Returns (CA coords, (rot, trans), [(rot, trans) per iteration])."""
        b, r, _ = s_init.shape
        s = self.dense(p["proj_s"], self.layer_norm(p["ln_s"], s_init, 4),
                       low=False)
        z_n = self.layer_norm(p["ln_z"], z, 4)
        rot = torch.eye(3, device=s.device).expand(b, r, 3, 3)
        trans = torch.zeros(b, r, 3, device=s.device)
        traj = []
        for _ in range(self.d.n_iterations):
            s = s + self.ipa(p["ipa"], s, z_n, rot, trans, seq_mask)
            s = self.layer_norm(p["ln_ipa"], s, 4)
            h = torch.relu(self.dense(p["trans1"], s, low=False))
            h = torch.relu(self.dense(p["trans2"], h, low=False))
            s = self.layer_norm(p["ln_trans"],
                                s + self.dense(p["trans3"], h, low=False), 4)
            upd = self.dense(p["bb_update"], s, low=False)
            quat = torch.cat([torch.ones_like(upd[..., :1]), upd[..., :3]], -1)
            rot_u = self.quat_to_rot(quat)
            trans_u = upd[..., 3:] * self.d.trans_scale
            trans = torch.einsum("bixy,biy->bix", rot, trans_u) + trans
            rot = torch.einsum("bixy,biyz->bixz", rot, rot_u)
            traj.append((rot, trans))
        return trans, (rot, trans), traj

    def structure_stage(self, params, msa_first, pair):
        """The structure module alone, on a fold's own Evoformer outputs
        (``msa_first`` its first MSA row, (r, c_m); ``pair`` (r, r, c_z))
        over real residues only: CA coords (r, 3)."""
        single = self.dense(params["single_proj"], msa_first[None].float(),
                            low=False)
        mask = torch.ones(1, msa_first.shape[0], device=msa_first.device)
        coords, _, _ = self.structure(params["structure"], single,
                                      pair[None].float(), mask)
        return coords[0]

    def iteration(self, params, batch, prev, keeps=None, remat=False):
        msa, pair = self.embed(params, batch, prev)
        seq_mask = batch["seq_mask"]
        pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
        msa, pair = self.evoformer(params["evoformer"], msa, pair,
                                   batch["msa_mask"], seq_mask, pair_mask,
                                   keeps, remat)
        single = self.dense(params["single_proj"], msa[:, 0], low=False)
        coords, frames, traj = self.structure(params["structure"], single,
                                              pair, seq_mask)
        return {"msa": msa, "pair": pair, "coords": coords, "frames": frames,
                "traj": traj,
                "msa_logits": self.dense(params["msa_head"], msa, low=False),
                "distogram_logits": self.dense(params["dist_head"], pair,
                                               low=False)}

    def forward(self, params, batch, keeps=None, train=False, remat=False):
        """All ``n_recycle`` + 1 passes. ``train``: the last pass builds the
        graph (with ``remat``, each Evoformer block checkpointed); the
        passes before it run without one. Every pass applies ``keeps``."""
        b, s, r = batch["msa"].shape
        dev = batch["msa"].device
        prev = (torch.zeros(b, r, self.d.d_msa, device=dev),
                torch.zeros(b, r, r, self.d.d_pair, device=dev),
                torch.zeros(b, r, 3, device=dev))
        with torch.no_grad():
            for _ in range(self.d.n_recycle):
                out = self.iteration(params, batch, prev, keeps)
                prev = (out["msa"][:, 0], out["pair"], out["coords"])
                del out
        self.grad_pass = train
        try:
            with torch.set_grad_enabled(train and torch.is_grad_enabled()):
                return self.iteration(params, batch, prev, keeps, remat)
        finally:
            self.grad_pass = False


# ---------------------------------------------------------------------------
# Loss and dropout
# ---------------------------------------------------------------------------

def _frames_from_ca(coords):
    prev_ca = torch.roll(coords, 1, dims=-2)
    next_ca = torch.roll(coords, -1, dims=-2)
    v1 = next_ca - coords
    v2 = prev_ca - coords
    e1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + 1e-8)
    u2 = v2 - e1 * torch.sum(e1 * v2, dim=-1, keepdim=True)
    e2 = u2 / (torch.linalg.norm(u2, dim=-1, keepdim=True) + 1e-8)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1), coords


def _fape(rot, trans, true_rot, true_trans, pos, true_pos, seq_mask,
          clamp=10.0, scale=10.0):
    def local(r, t, x):
        return torch.einsum("bixy,bijx->bijy", r, x[:, None] - t[:, :, None])
    err = torch.sqrt(torch.sum(torch.square(
        local(rot, trans, pos) - local(true_rot, true_trans, true_pos)),
        dim=-1) + 1e-8)
    err = torch.clamp(err, max=clamp) / scale
    mask2 = seq_mask[:, :, None] * seq_mask[:, None, :]
    return (err * mask2).sum() / (mask2.sum() + 1e-6)


def alphafold_loss(out, batch, w_fape=0.5, w_msa=2.0, w_dist=0.3, w_aux=0.5):
    """Masked-MSA, distogram and CA-only FAPE with the trajectory's mean
    FAPE, weighted as FastFold weighs them."""
    seq_mask = batch["seq_mask"]
    true_pos = batch["pseudo_beta"]
    true_rot, true_trans = _frames_from_ca(true_pos)
    rot, trans = out["frames"]
    l_fape = _fape(rot, trans, true_rot, true_trans, trans, true_pos, seq_mask)
    l_aux = torch.stack([_fape(r, t, true_rot, true_trans, t, true_pos,
                               seq_mask) for r, t in out["traj"]]).mean()
    logp = torch.log_softmax(out["msa_logits"], dim=-1)
    ll = torch.gather(logp, -1, batch["true_msa"].long()[..., None])[..., 0]
    bert = batch["bert_mask"]
    l_msa = -(ll * bert).sum() / (bert.sum() + 1e-6)
    d = torch.linalg.norm(true_pos[:, :, None] - true_pos[:, None] + 1e-8,
                          dim=-1)
    edges = torch.linspace(2.3125, 21.6875, N_DIST_BINS - 1, device=d.device)
    target = torch.sum(d[..., None] > edges, dim=-1)
    logp = torch.log_softmax(out["distogram_logits"], dim=-1)
    ll = torch.gather(logp, -1, target[..., None])[..., 0]
    mask2 = seq_mask[:, :, None] * seq_mask[:, None, :]
    l_dist = -(ll * mask2).sum() / (mask2.sum() + 1e-6)
    return w_fape * l_fape + w_aux * l_aux + w_msa * l_msa + w_dist * l_dist


def draw_dropout_keeps(d: Dims, batch_shape, generator, device=None):
    """Every block's dropout masks for one step, drawn from ``generator`` in
    block order and ``DROPOUT_SITES`` order: a Bernoulli(1 - rate) 0/1
    mask, of size 1 along the axis that shares a draw."""
    b, s, r = batch_shape
    widths = {site: (r, r, d.d_pair, d.dropout_pair) for site in DROPOUT_SITES}
    widths["msa_row"] = (s, r, d.d_msa, d.dropout_msa)
    keeps = []
    for _ in range(d.n_blocks):
        block = {}
        for site, axis in DROPOUT_SITES.items():
            d1, d2, c, rate = widths[site]
            shape = [b, d1, d2, c]
            shape[axis] = 1
            u = torch.rand(shape, generator=generator,
                           device=generator.device)
            block[site] = (u < 1.0 - rate).float().to(device)
        keeps.append(block)
    return keeps
