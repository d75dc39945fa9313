"""AutoChunk: the activation-memory planner of the Evoformer's chunk knobs,
and the serving engine's decoder block planner.

The port's copy of the reference's ``memory/autochunk.py``. The decoder
half (``plan_decoder_blocks``, ``check_decoder_admission``,
``decoder_attention_bytes``) is the reference's, term for term; its
default budget is the device's own (``device.hbm_budget_bytes``), where
the reference's is its TPU's HBM.

The Evoformer half: given the static shapes of a forward, the compute
dtype, the branch each site takes and a device-memory budget, it picks

  * ``inference_chunk`` — paper §V.C group chunking of the attention sites,
  * ``opm_chunk``       — j blocks of the materialized outer-product-mean,
  * ``attn_kv_tile``, ``tri_k_tile``, ``opm_s_tile`` — the fused ops' tiles,

as the least-chunked settings whose modelled peak fits the budget (0 = off,
chosen whenever the unchunked plan fits). The search is the reference's:
its candidates, its order of preference (fewest sequential inference
chunks first, then OPM j-blocks, then the tiles), knobs set by hand pinned,
``fits=False`` with the smallest plan when nothing fits, and a chunk that
does not divide its extent modelled as no chunk, because the forward then
runs unchunked (``_eff_div_chunk``). Planning is pure Python over static
shapes, once per forward, and never catches an out-of-memory error.

The model is the reference's dominant-term model: each term is the size of
one live dominant buffer and the peak is their sum over the block's phases.
Its terms for a materialized branch (the plain versions, and the fused
softmax kernel K4, which allocates what the reference's jnp softmax does)
are the reference's, term by term. Its terms for a kernel branch count what
the port's kernel and wrapper allocate on the card:

  * attention (K5): q, k, v and the output, and K5's fp32 log-sum-exp. K5
    keeps no (G, H, S, kv_tile) block (the reference's term models its own
    backward's recompute block), so ``attn_kv_tile`` moves nothing;
  * triangle (K7): the merged projections and output-gate logits, then the
    larger of the fp32 gating of b and the bf16 workspace of K7's pre-pass
    (the gated a and b in fragment order) with its output and statistics;
    ``tri_k_tile`` moves nothing;
  * outer-product-mean (K8): the masked projections and K8's output; K8
    keeps its s ring on chip, so neither ``opm_s_tile`` nor ``opm_chunk``
    moves anything.

A knob that moves nothing on the branch a site takes costs serialisation
and saves nothing, so the planner never picks it; set by hand it is still
pinned and passed down. On the CPU the plain versions stand in for the
kernels and allocate more than these terms say; the CPU has no device
budget to protect (``device.CPU_HBM_BYTES``).

What lies outside the block and is live while it runs (the recycled fp32
state, the pair mask and the inputs the callers hold) is
``outside_block_bytes``; the forward hands the planner its budget less
those bytes (``core.alphafold.planned_evoformer``). The structure module
and the heads run after the trunk, over the pair in fp32: at FULL widths
their peak stays below the trunk's (``scripts/torch_fold_memory.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from repro_torch.device import hbm_budget_bytes
from repro_torch.kernels.triangle import triangle_workspace


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _eff_div_chunk(total: int, chunk: int) -> int:
    """Effective extent of a CHUNK knob, as the forward runs it:
    ``_gated_attention`` and ``outer_product_mean`` run unchunked where the
    chunk does not divide the extent, so such a chunk is the whole extent."""
    if chunk and 0 < chunk < total and total % chunk == 0:
        return chunk
    return total


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Memory model
# ---------------------------------------------------------------------------


def attention_transient_bytes(groups: int, heads: int, seq: int,
                              head_dim: int, *, kv_len: int | None = None,
                              kv_tile: int = 0, fused: bool = True,
                              dtype_bytes: int = 2) -> int:
    """Peak transient of one gated-attention site over ``groups`` rows.

    Kernel branch (K5): q, k, v and the output in the compute dtype plus
    K5's fp32 (groups, heads, seq) log-sum-exp; ``kv_tile`` has no effect.
    Scores-materialized branch: the reference's two (groups, heads, seq,
    kv_len) copies, the scores and the fused softmax's probabilities."""
    kv = kv_len if kv_len is not None else seq
    qkvo = 4 * groups * seq * heads * head_dim * dtype_bytes
    if fused:
        return qkvo + groups * heads * seq * 4
    return qkvo + 2 * groups * heads * seq * kv * dtype_bytes


def triangle_transient_bytes(rows_loc: int, n_res: int, c_mult: int, *,
                             tile: int = 0, fused: bool = True,
                             dtype_bytes: int = 2,
                             d_out: int | None = None) -> int:
    """Peak transient of one triangular multiplicative update over
    ``rows_loc`` pair rows.

    Kernel branch (K7): the merged a/b projection and gate (2c each) and the
    output-gate logits (d_out) in the compute dtype, then the larger of two
    phases: the fp32 gating of b (b, sigmoid(gate) and their product; two
    fp32 tensors where the compute dtype is fp32 already), or the gated b,
    K7's bf16 workspace (``kernels.triangle.triangle_workspace``), its
    output and its fp32 LN statistics. ``tile`` has no effect.
    Materialized branch: the reference's operands plus the full
    (rows_loc, r, c) fp32 product."""
    if not fused:
        operands = c_mult * dtype_bytes * (4 * rows_loc * n_res
                                           + n_res * n_res)
        return operands + rows_loc * n_res * c_mult * 4
    d = d_out if d_out is not None else c_mult
    px = rows_loc * n_res
    proj = px * (4 * c_mult + d) * dtype_bytes
    gating = (3 if dtype_bytes < 4 else 2) * px * c_mult * 4
    ws = (triangle_workspace(1, rows_loc, n_res, n_res, c_mult, d)["numel"]
          * dtype_bytes if dtype_bytes == 2 else 0)
    kernel = px * c_mult * dtype_bytes + ws + px * d * dtype_bytes + 2 * px * 4
    return proj + max(gating, kernel)


def opm_transient_bytes(rows_loc: int, n_res: int, n_seq: int, c_opm: int, *,
                        tile: int = 0, opm_chunk: int = 0, fused: bool = True,
                        dtype_bytes: int = 2,
                        d_out: int | None = None) -> int:
    """Peak transient of the outer-product-mean over ``rows_loc`` pair rows.

    Kernel branch (K8): the merged projection (2c) and the masked a and b
    in the compute dtype, and K8's (rows_loc, r, d_out) output; neither
    ``tile`` nor ``opm_chunk`` has an effect. Materialized branch: the
    reference's gathered right projection plus the fp32 (rows_loc, j, c, c)
    outer product, j bounded by the ``opm_chunk`` blocks (r when off)."""
    gathered = n_seq * n_res * c_opm * dtype_bytes
    if fused:
        d = d_out if d_out is not None else c_opm * c_opm
        return 4 * gathered + rows_loc * n_res * d * dtype_bytes
    jc = _eff_div_chunk(n_res, opm_chunk)
    return gathered + rows_loc * jc * c_opm * c_opm * 4


def evoformer_peak_bytes(cfg, *, batch: int, n_seq: int, n_res: int,
                         dap: int = 1, fused: bool = True,
                         inference_chunk: int = 0, opm_chunk: int = 0,
                         attn_kv_tile: int = 0, tri_k_tile: int = 0,
                         opm_s_tile: int = 0,
                         fused_triangle: bool | None = None,
                         fused_opm: bool | None = None,
                         dtype: torch.dtype = torch.bfloat16) -> dict:
    """Dominant activation terms (bytes) of one Evoformer block, per rank
    under DAP over ``dap`` ranks (the gathered operands whole); their sum
    is the modelled peak. ``fused`` is the attention sites' branch (the
    reference's single flag); ``fused_triangle`` and ``fused_opm`` the
    triangle updates' and the OPM's, ``fused`` where None. ``dtype`` is the
    compute dtype (the reference's EvoformerConfig default, bf16, unless
    given)."""
    ft = fused if fused_triangle is None else fused_triangle
    fo = fused if fused_opm is None else fused_opm
    dt = _itemsize(dtype)
    s_loc = _ceil_div(n_seq, dap)
    r_loc = _ceil_div(n_res, dap)
    terms = {
        # A few live copies of each representation (input, LN'ed, update).
        "msa_rep": 3 * batch * s_loc * n_res * cfg.d_msa * dt,
        "pair_rep": 3 * batch * r_loc * n_res * cfg.d_pair * dt,
        # The (B, H, r, r) pair-bias tensors: not chunkable.
        "pair_bias": batch * max(cfg.msa_heads, cfg.pair_heads)
        * n_res * n_res * dt,
        "tri_mult": batch * triangle_transient_bytes(
            r_loc, n_res, cfg.tri_mult_dim, tile=tri_k_tile, fused=ft,
            dtype_bytes=dt, d_out=cfg.d_pair),
    }
    # MSA row (groups = MSA rows) and triangle (groups = pair rows) phases
    # do not overlap: the larger.
    attn_row = attention_transient_bytes(
        batch * _eff_div_chunk(s_loc, inference_chunk), cfg.msa_heads, n_res,
        cfg.head_dim, kv_tile=attn_kv_tile, fused=fused, dtype_bytes=dt)
    attn_tri = attention_transient_bytes(
        batch * _eff_div_chunk(r_loc, inference_chunk), cfg.pair_heads, n_res,
        cfg.head_dim, kv_tile=attn_kv_tile, fused=fused, dtype_bytes=dt)
    terms["attention"] = max(attn_row, attn_tri)
    terms["opm"] = batch * opm_transient_bytes(
        r_loc, n_res, n_seq, cfg.opm_dim, tile=opm_s_tile,
        opm_chunk=opm_chunk, fused=fo, dtype_bytes=dt, d_out=cfg.d_pair)
    if dap > 1:
        # Under DAP each rank holds the all-gathers' whole results: while a
        # gathered (B, H, r, r) bias is placed, its receive buffer beside
        # it; on the triangle kernel's branch the gathered (B, r, r, c) b
        # and its receive buffer (the materialized branch's operands count
        # the gathered b already).
        terms["gathers"] = batch * n_res * n_res * dt * max(
            max(cfg.msa_heads, cfg.pair_heads),
            (2 if ft else 1) * cfg.tri_mult_dim)
    return terms


def modeled_evoformer_peak(cfg, *, batch: int, n_seq: int, n_res: int,
                           dap: int = 1, fused: bool = True,
                           fused_triangle: bool | None = None,
                           fused_opm: bool | None = None,
                           dtype: torch.dtype = torch.bfloat16) -> int:
    """The modelled peak with the config's own knobs."""
    return sum(evoformer_peak_bytes(
        cfg, batch=batch, n_seq=n_seq, n_res=n_res, dap=dap, fused=fused,
        inference_chunk=cfg.inference_chunk, opm_chunk=cfg.opm_chunk,
        attn_kv_tile=cfg.attn_kv_tile, tri_k_tile=cfg.tri_k_tile,
        opm_s_tile=cfg.opm_s_tile, fused_triangle=fused_triangle,
        fused_opm=fused_opm, dtype=dtype).values())


def outside_block_bytes(cfg, *, batch: int, n_seq: int, n_res: int,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the forward keeps live outside the Evoformer block while the
    block runs: the recycled fp32 state (the first MSA row, the pair and
    the positions), the fp32 pair mask, and two copies of the MSA and pair
    representations in the compute dtype (the trunk's input, held by
    ``alphafold_iteration``, and the block's input, held by
    ``evoformer_stack``; measured by ``scripts/torch_fold_memory.py``).
    ``cfg``: the EvoformerConfig."""
    dt = _itemsize(dtype)
    return {"prev": 4 * batch * n_res * (cfg.d_msa + n_res * cfg.d_pair + 3),
            "pair_mask": 4 * batch * n_res * n_res,
            "inputs": 2 * batch * n_res * (n_seq * cfg.d_msa
                                           + n_res * cfg.d_pair) * dt}


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkPlan:
    inference_chunk: int = 0
    opm_chunk: int = 0
    attn_kv_tile: int = 0
    est_bytes: int = 0
    budget_bytes: int = 0
    fits: bool = True
    tri_k_tile: int = 0
    opm_s_tile: int = 0

    def describe(self) -> str:
        return (f"ic={self.inference_chunk} oc={self.opm_chunk} "
                f"kt={self.attn_kv_tile} tt={self.tri_k_tile} "
                f"ot={self.opm_s_tile} est={self.est_bytes >> 20}MB "
                f"budget={self.budget_bytes >> 20}MB fits={self.fits}")


_IC_CANDIDATES = (0, 256, 128, 64, 32, 16, 8, 4, 2, 1)
_OC_CANDIDATES = (0, 1024, 512, 256, 128, 64, 32, 16, 8)
_KT_CANDIDATES = (0, 256, 128)
_TT_CANDIDATES = (0, 64, 32, 16)
_OT_CANDIDATES = (0, 64, 32, 16)


def _knob_candidates(fixed: int, options, limit: int):
    if fixed:
        return (fixed,)
    return tuple(o for o in options if o == 0 or o < limit) or (0,)


def _div_candidates(fixed: int, options, *totals):
    """Candidates for a CHUNK knob: 0 plus the options that divide one of
    the chunked extents, and those extents halved, quartered and so on."""
    if fixed:
        return (fixed,)
    cands: set[int] = set()
    for total in totals:
        cands |= {o for o in options if 0 < o < total and total % o == 0}
        cands |= {total // k for k in (2, 4, 8, 16, 32, 64)
                  if total % k == 0 and 1 <= total // k < total}
    return (0,) + tuple(sorted(cands, reverse=True))


@functools.lru_cache(maxsize=256)
def _search_space(cfg, batch: int, n_seq: int, n_res: int, dap: int,
                  fused: bool, ft: bool, fo: bool, dtype):
    """Every candidate as (serialisation key, modelled bytes, knobs) in the
    reference's loop order, sorted stably by key, and the candidate of
    least bytes (the first such in loop order). Cached per shape and
    branch, so a forward's plan costs one scan for its budget."""
    s_loc = _ceil_div(n_seq, dap)
    r_loc = _ceil_div(n_res, dap)
    groups = max(s_loc, r_loc)
    ics = _div_candidates(cfg.inference_chunk, _IC_CANDIDATES, s_loc, r_loc)
    ocs = _div_candidates(cfg.opm_chunk, _OC_CANDIDATES, n_res)
    kts = _knob_candidates(cfg.attn_kv_tile, _KT_CANDIDATES,
                           n_res if fused else 1)
    tts = _knob_candidates(cfg.tri_k_tile, _TT_CANDIDATES,
                           n_res if ft else 1)
    ots = _knob_candidates(cfg.opm_s_tile, _OT_CANDIDATES,
                           n_res if fo else 1)
    rows = []
    for ic in ics:
        for oc in ocs:
            for kt in kts:
                for tt in tts:
                    for ot in ots:
                        e = sum(evoformer_peak_bytes(
                            cfg, batch=batch, n_seq=n_seq, n_res=n_res,
                            dap=dap, fused=fused, inference_chunk=ic,
                            opm_chunk=oc, attn_kv_tile=kt, tri_k_tile=tt,
                            opm_s_tile=ot, fused_triangle=ft, fused_opm=fo,
                            dtype=dtype).values())
                        # Fewest sequential attention chunks first, then OPM
                        # j-blocks, then the tiles.
                        key = (_ceil_div(groups, ic) if ic else 0,
                               _ceil_div(n_res, oc) if oc else 0,
                               _ceil_div(n_res, kt) if kt else 0,
                               _ceil_div(n_res, tt) if tt else 0,
                               _ceil_div(n_res, ot) if ot else 0)
                        rows.append((key, e, (ic, oc, kt, tt, ot)))
    smallest = min(rows, key=lambda row: row[1])
    return tuple(sorted(rows, key=lambda row: row[0])), smallest


def plan_evoformer_chunks(cfg, *, batch: int, n_seq: int, n_res: int,
                          budget_bytes: int, dap: int = 1,
                          fused: bool = True,
                          fused_triangle: bool | None = None,
                          fused_opm: bool | None = None,
                          dtype: torch.dtype = torch.bfloat16) -> ChunkPlan:
    """The least-chunked knobs whose modelled peak fits ``budget_bytes``;
    nonzero knobs on ``cfg`` are pinned. Never over the budget when any
    candidate fits; otherwise the plan of least modelled bytes, with
    ``fits=False``."""
    ft = fused if fused_triangle is None else fused_triangle
    fo = fused if fused_opm is None else fused_opm
    by_key, smallest = _search_space(cfg, batch, n_seq, n_res, dap, fused,
                                     ft, fo, dtype)
    for _, e, (ic, oc, kt, tt, ot) in by_key:
        if e <= budget_bytes:
            return ChunkPlan(ic, oc, kt, e, budget_bytes, True, tt, ot)
    _, e, (ic, oc, kt, tt, ot) = smallest
    return ChunkPlan(ic, oc, kt, e, budget_bytes, False, tt, ot)


def apply_plan(cfg, plan: ChunkPlan):
    """EvoformerConfig with the plan's knobs filled in; knobs set by hand
    on ``cfg`` win (the planner pinned them already)."""
    return dataclasses.replace(
        cfg,
        inference_chunk=cfg.inference_chunk or plan.inference_chunk,
        opm_chunk=cfg.opm_chunk or plan.opm_chunk,
        attn_kv_tile=cfg.attn_kv_tile or plan.attn_kv_tile,
        tri_k_tile=cfg.tri_k_tile or plan.tri_k_tile,
        opm_s_tile=cfg.opm_s_tile or plan.opm_s_tile,
    )


def site_branches(cfg, *, batch: int, n_seq: int, n_res: int, device=None,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """The branch each kind of site takes under the current plan on
    ``device``: ``fused`` (attention, judged at the MSA row's shape as the
    reference judges it), ``fused_triangle`` and ``fused_opm``."""
    from repro_torch.kernels import ops

    return {
        "fused": ops.fused_attention_supported(
            (batch, n_seq, n_res, cfg.msa_heads, cfg.head_dim), kv_len=n_res,
            dtype=dtype, device=device),
        "fused_triangle": ops.fused_triangle_supported(
            cfg.tri_mult_dim, cfg.d_pair, dtype, device),
        "fused_opm": ops.fused_opm_supported(cfg.opm_dim, cfg.d_pair, dtype,
                                             device),
    }


def evoformer_chunk_plan(cfg, *, batch: int, n_seq: int, n_res: int,
                         dap: int = 1, budget_bytes: int | None = None,
                         device=None,
                         dtype: torch.dtype = torch.bfloat16) -> ChunkPlan:
    """The plan ``resolve_evoformer_config`` applies: the branches the
    current plan gives on ``device``, and ``budget_bytes`` (None: the
    current plan's ``MemoryPolicy.hbm_budget``, else the device's,
    ``device.hbm_budget_bytes``)."""
    if budget_bytes is None:
        from repro_torch.exec.plan import current_plan

        budget_bytes = (current_plan().memory.hbm_budget
                        or hbm_budget_bytes(device))
    return plan_evoformer_chunks(
        cfg, batch=batch, n_seq=n_seq, n_res=n_res, budget_bytes=budget_bytes,
        dap=dap, dtype=dtype, **site_branches(
            cfg, batch=batch, n_seq=n_seq, n_res=n_res, device=device,
            dtype=dtype))


def resolve_evoformer_config(cfg, *, batch: int, n_seq: int, n_res: int,
                             dap: int = 1, budget_bytes: int | None = None,
                             device=None,
                             dtype: torch.dtype = torch.bfloat16):
    """AutoChunk's entry point: ``cfg`` with every knob left at 0 replaced
    by the planned value (``evoformer_chunk_plan``); ``cfg`` itself when
    ``cfg.auto_chunk`` is False."""
    if not cfg.auto_chunk:
        return cfg
    return apply_plan(cfg, evoformer_chunk_plan(
        cfg, batch=batch, n_seq=n_seq, n_res=n_res, dap=dap,
        budget_bytes=budget_bytes, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# Decoder / serving planner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecoderPlan:
    attn_q_block: int
    attn_kv_block: int
    est_bytes: int
    budget_bytes: int
    fits: bool


def decoder_attention_bytes(cfg, *, n_slots: int, max_seq: int,
                            q_block: int, kv_block: int,
                            seq_len: int | None = None) -> int:
    """Dominant serving-time bytes: the batched KV cache, the prefill's
    fp32 probabilities block, its bf16 activations and the logits. cfg is a
    ModelConfig. ``seq_len`` bounds the prefill terms to a prompt's length
    (admission queries); None models the worst case (``max_seq``)."""
    hd = cfg.resolved_head_dim
    dt = 1 if getattr(cfg, "kv_cache_int8", False) else 2
    s = min(seq_len or max_seq, max_seq)
    cache = cfg.n_layers * n_slots * max_seq * 2 * cfg.n_kv * hd * dt
    qb = min(q_block or s, s)
    kvb = min(kv_block or s, s)
    probs = cfg.n_heads * qb * kvb * 4
    acts = 3 * s * cfg.n_heads * hd * 2
    logits = n_slots * cfg.vocab * 4
    return cache + probs + acts + logits


@dataclass(frozen=True)
class AdmissionCheck:
    """Result of a serving-engine admission query (see
    ``check_decoder_admission``)."""

    fits: bool
    est_bytes: int
    budget_bytes: int
    seq_len: int

    def describe(self) -> str:
        return (f"seq_len={self.seq_len} est={self.est_bytes >> 20}MB "
                f"budget={self.budget_bytes >> 20}MB fits={self.fits}")


_MIN_BLOCK = 32   # the most-shrunk attention block plan_decoder_blocks tries


def check_decoder_admission(cfg, *, n_slots: int, max_seq: int,
                            seq_len: int | None = None,
                            budget_bytes: int | None = None,
                            device=None) -> AdmissionCheck:
    """Can a request of ``seq_len`` tokens run in an engine of (n_slots,
    max_seq) within ``budget_bytes`` (None: ``hbm_budget_bytes(device)``)?
    The engine can always shrink its attention blocks but not its KV
    cache, so a request is admissible iff the most-shrunk block plan
    fits. Pure Python over static shapes."""
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(device)
    s = min(seq_len or max_seq, max_seq)
    est = decoder_attention_bytes(
        cfg, n_slots=n_slots, max_seq=max_seq,
        q_block=min(_MIN_BLOCK, s), kv_block=min(_MIN_BLOCK, s),
        seq_len=s)
    return AdmissionCheck(est <= budget_bytes, est, budget_bytes, s)


def plan_decoder_blocks(cfg, *, n_slots: int, max_seq: int,
                        budget_bytes: int | None = None, device=None):
    """The serving engine's AutoChunk: keep the configured attention blocks
    when they fit the budget (None: ``hbm_budget_bytes(device)``), else
    shrink, the KV block first, then the q block. Returns (ModelConfig,
    DecoderPlan)."""
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(device)
    q_opts = [cfg.attn_q_block] + [b for b in (256, 128, 64, 32)
                                   if not cfg.attn_q_block
                                   or b < cfg.attn_q_block]
    kv_opts = [cfg.attn_kv_block] + [b for b in (512, 256, 128, 64, 32)
                                     if not cfg.attn_kv_block
                                     or b < cfg.attn_kv_block]
    best = None
    for qb in q_opts:              # outer: shrink q last
        for kvb in kv_opts:        # inner: shrink kv first
            e = decoder_attention_bytes(cfg, n_slots=n_slots,
                                        max_seq=max_seq, q_block=qb,
                                        kv_block=kvb)
            if best is None or e < best[0]:
                best = (e, qb, kvb)
            if e <= budget_bytes:
                plan = DecoderPlan(qb, kvb, e, budget_bytes, fits=True)
                return dataclasses.replace(
                    cfg, attn_q_block=qb, attn_kv_block=kvb), plan
    e, qb, kvb = best
    plan = DecoderPlan(qb, kvb, e, budget_bytes, fits=False)
    return dataclasses.replace(cfg, attn_q_block=qb, attn_kv_block=kvb), plan
