"""Batched serving engine for the decoder LMs: slot-based continuous
batching over the decoder's prefill and decode steps. The port of the
reference's ``serving/engine.py``, behaviour for behaviour.

Design: a fixed number of slots share one batched cache (KV rows, MLA's
latent rows or recurrent states; every leaf has the batch on axis 0).
Requests are admitted into free slots (a batch-1 prefill, its cache rows
copied into the slot), all active slots advance together with one
batched decode step per token, and a finished sequence frees its slot at
once. The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), and its parameters must already lie there; its
compute dtype is
``model_forward``'s default, bf16, and each weight is cast where the
reference casts it, per call.

Memory: the attention blocks come from the decoder planner
(``memory.autochunk.plan_decoder_blocks``): the configured
``attn_q_block``/``attn_kv_block`` are kept when the KV cache and prefill
transients fit the budget, else shrunk (KV block first). The budget is the
bound plan's ``MemoryPolicy.hbm_budget``, else the device's own
(``device.hbm_budget_bytes``). ``auto_plan=False`` keeps the config's.

Execution policy: the engine binds one ExecutionPlan (default: the ambient
``current_plan()``), and ``submit(..., plan=...)`` overrides it per request,
e.g. an oracle-leg canary beside default-plan requests. Each request's
prefill runs under its own plan; a decode step groups the active slots by
plan and runs one batched decode per plan over the whole batch, committing
only that group's cache rows and logits. ``model_forward``'s decode
returns new cache tensors and leaves the engine's untouched, and a group's
rows are copied into the engine's cache before the next group runs, which
reads only its own rows: slots are independent in a decode step, so the
result is the reference's (each group from the same old cache).

Failure handling (every path deterministic under
``resilience.inject_faults``; ``repro_torch/resilience/__init__.py`` has
the fault-site, retry and degradation matrix):

  * Admission control: ``submit`` rejects, with a typed ``AdmissionError``,
    prompts over ``max_seq``, submissions past ``max_pending``, and
    requests whose ``(plan, length)`` exceeds the ``check_decoder_admission``
    model under the plan's budget (``admission_control=False`` defers the
    budget check to admission time).
  * Deadlines: ``submit(..., deadline=N)`` fails the request with
    ``DeadlineExceeded`` once N engine steps elapse, queued or active.
  * Retry: ``submit(..., retry=RetryPolicy(...))`` requeues retryable
    failures through the slot teardown with capped exponential backoff in
    engine steps; the retry re-prefills from scratch.
  * Non-finite guard: each decode group's logits carry a per-slot
    finiteness flag; a non-finite slot is quarantined alone.
  * Degradation: an OOM (injected ``OomFault`` or the card's "CUDA out of
    memory") retries the request under ``plan.degrade()`` rungs, recorded
    on ``Request.fallback_chain``; an exhausted ladder fails typed.
  * No livelock: ``run()`` fails, typed, a queue that can make no progress.

The port has no jit. ``obs`` events keep the reference's schema all the
same: one ``jit_entry`` event per prefill and decode call, keyed by its
plan's label, beside the ``prefill``/``decode`` timed calls.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import hbm_budget_bytes, resolve_device
from repro_torch.exec.plan import ExecutionPlan, current_plan, use_plan
from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.memory.autochunk import (check_decoder_admission,
                                          plan_decoder_blocks)
from repro_torch.models.decoder import init_cache, model_forward
from repro_torch.obs import trace as obs
from repro_torch.resilience.errors import AdmissionError, DeadlineExceeded
from repro_torch.resilience.faults import (InjectedFault, NonFiniteFault,
                                           fire, is_oom)
from repro_torch.resilience.retry import RetryPolicy


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                     # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0               # 0 => greedy
    eos_id: Optional[int] = None
    # execution plan this request runs under (engine default when None)
    plan: Optional[ExecutionPlan] = None
    # failure policy: deadline in engine steps, retry policy for transients
    deadline: Optional[int] = None
    retry: Optional[RetryPolicy] = None
    # outputs / lifecycle
    generated: list = field(default_factory=list)
    done: bool = False
    status: str = "queued"                 # queued | active | done | failed
    error: Optional[BaseException] = None
    attempts: int = 0                      # admissions started (prefills)
    fallback_chain: list = field(default_factory=list)  # degraded plans
    # internal scheduling state (engine steps)
    _ready_step: int = 0
    _deadline_step: Optional[int] = None


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float) -> torch.Tensor:
    """Greedy (``temperature <= 0``): the first index of the largest
    logit, as ``jnp.argmax``. Otherwise a categorical draw from
    ``softmax(logits / temperature)`` by the Gumbel-max rule with
    ``generator`` (on the logits' device): the same distribution as the
    reference's ``jax.random.categorical``, never its bits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


@torch.no_grad()
def _prefill_step(params, prompt, *, cfg: ModelConfig, plan: ExecutionPlan,
                  max_cache_len: int):
    with use_plan(plan):
        return model_forward(params, prompt, cfg, mode="prefill",
                             max_cache_len=max_cache_len)


@torch.no_grad()
def _decode_step(params, toks, cache, lengths, *, cfg: ModelConfig,
                 plan: ExecutionPlan):
    with use_plan(plan):
        out = model_forward(params, toks, cfg, mode="decode", cache=cache,
                            lengths=lengths)
    # Per-slot non-finite guard (the logits are not changed by it).
    finite = torch.isfinite(out["logits"]).all(dim=2).all(dim=1)
    return out, finite


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 max_seq: int = 512, dtype=torch.bfloat16,
                 auto_plan: bool = True, hbm_budget: int | None = None,
                 plan: ExecutionPlan | None = None,
                 max_pending: int | None = 256,
                 admission_control: bool = True, device=None):
        """``device``: None means the card (``device.resolve_device``,
        which raises when there is none); ``"cpu"`` is the explicit opt-in.
        Every parameter must already lie on it: the engine moves nothing."""
        want = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device.type != want.type or (
                    want.index is not None and leaf.device != want):
                raise ValueError(
                    f"ServingEngine runs on {want} but a parameter lies on "
                    f"{leaf.device}; move the parameters there or pass "
                    f"device={str(leaf.device)!r}")
        self.params = params
        self.device = params["embed"]["table"].device
        self.plan = plan if plan is not None else current_plan()
        if hbm_budget is None:
            hbm_budget = (self.plan.memory.hbm_budget
                          or hbm_budget_bytes(self.device))
        self._hbm_budget = hbm_budget
        if auto_plan:
            cfg, self.block_plan = plan_decoder_blocks(
                cfg, n_slots=n_slots, max_seq=max_seq,
                budget_bytes=hbm_budget)
        else:
            self.block_plan = None
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.max_pending = max_pending
        self.admission_control = admission_control
        self.cache = init_cache(cfg, n_slots, max_seq, dtype,
                                device=self.device)
        # Lengths live on the host: the scheduler reads them every step.
        self.lengths = np.zeros((n_slots,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._next_uid = 0
        self._step_count = 0
        leaves = tree_leaves(self.params)
        self._param_count = sum(x.numel() for x in leaves)
        self._param_bytes = sum(x.numel() * x.element_size() for x in leaves)
        self._cache_row_bytes = sum(
            (x.numel() // n_slots // max_seq) * x.element_size()
            for x in tree_leaves(self.cache))
        self._meta_emitted: set[int] = set()

    # --- observability (no-ops when no tracer is scoped) ---

    def _tr(self):
        """Current tracer (or None), emitting the engine's run-metadata
        event once per tracer."""
        tr = obs.current_tracer()
        if tr is not None and id(tr) not in self._meta_emitted:
            self._meta_emitted.add(id(tr))
            tr.emit("meta", "engine", attrs={
                "model": self.cfg.name, "n_slots": self.n_slots,
                "max_seq": self.max_seq,
                "param_count": self._param_count,
                "param_bytes": self._param_bytes,
                "cache_row_bytes": self._cache_row_bytes,
                "plan": self._plan_label(tr, self.plan)})
        return tr

    @staticmethod
    def _plan_label(tr, plan: ExecutionPlan) -> str:
        """Interned ``plan:N`` label: the serialized plan appears once in a
        ``def`` event; a plan holding a live process group falls back to
        its describe() string."""
        try:
            val = plan.to_dict()
        except ValueError:
            val = plan.describe()
        return tr.define("plan", val)

    def _req_event(self, tr, phase: str, req: Optional[Request], **attrs):
        tr.emit("request", phase,
                uid=req.uid if req is not None else None, attrs=attrs)

    def _admission(self, req: Request):
        budget = req.plan.memory.hbm_budget or self._hbm_budget
        return check_decoder_admission(
            self.cfg, n_slots=self.n_slots, max_seq=self.max_seq,
            seq_len=int(req.prompt.shape[-1]), budget_bytes=budget)

    def submit(self, prompt: np.ndarray, *,
               plan: ExecutionPlan | None = None,
               deadline: int | None = None,
               retry: RetryPolicy | None = None, **kw) -> Request:
        """Queue a request. ``plan`` overrides the engine's bound plan for
        this request only (its prefill and its decode group); ``deadline``
        is a budget in engine steps; ``retry`` opts retryable failures into
        a slot-safe requeue with backoff. Raises ``AdmissionError`` on an
        over-length prompt, a full pending queue, or a (plan, length) over
        the memory model."""
        tr = self._tr()
        prompt = np.asarray(prompt, np.int32)
        if prompt.shape[-1] > self.max_seq:
            # An over-length prompt would prefill past the cache's extent.
            if tr is not None:
                self._req_event(tr, "rejected", None, reason="over_length",
                                prompt_len=int(prompt.shape[-1]))
            raise AdmissionError(
                f"prompt length {prompt.shape[-1]} exceeds the engine's "
                f"max_seq={self.max_seq}")
        if self.max_pending is not None and \
                len(self.pending) >= self.max_pending:
            if tr is not None:
                self._req_event(tr, "rejected", None, reason="queue_full",
                                queue_depth=len(self.pending))
            raise AdmissionError(
                f"pending queue full ({self.max_pending} requests): "
                f"backpressure — drain or retry later")
        req = Request(uid=self._next_uid, prompt=prompt,
                      plan=plan if plan is not None else self.plan,
                      deadline=deadline, retry=retry, **kw)
        if self.admission_control:
            chk = self._admission(req)
            if not chk.fits:
                if tr is not None:
                    self._req_event(tr, "rejected", None, reason="hbm_model",
                                    prompt_len=int(prompt.shape[-1]),
                                    plan=self._plan_label(tr, req.plan))
                raise AdmissionError(
                    f"request would exceed the HBM model under its plan: "
                    f"{chk.describe()}")
        self._next_uid += 1
        if deadline is not None:
            req._deadline_step = self._step_count + deadline
        self.pending.append(req)
        if tr is not None:
            self._req_event(tr, "queued", req,
                            prompt_len=int(prompt.shape[-1]),
                            plan=self._plan_label(tr, req.plan),
                            queue_depth=len(self.pending),
                            deadline=deadline)
        return req

    # --- internals ---

    def _teardown(self, slot: int):
        """Free a slot (release, failure, quarantine and requeue all come
        through here)."""
        self.slot_req[slot] = None
        self.lengths[slot] = 0

    def _release(self, slot: int, req: Request):
        """Finish a request successfully and free its slot."""
        req.done = True
        req.status = "done"
        self.finished.append(req)
        self._teardown(slot)
        tr = self._tr()
        if tr is not None:
            self._req_event(tr, "done", req, slot=slot,
                            step=self._step_count,
                            tokens=len(req.generated),
                            attempts=req.attempts,
                            degraded=len(req.fallback_chain))

    def _fail(self, slot: Optional[int], req: Request, err: BaseException):
        """Terminate a request with a typed error (slot=None: not admitted)."""
        if slot is not None:
            self._teardown(slot)
        req.status = "failed"
        req.error = err
        self.finished.append(req)
        tr = self._tr()
        if tr is not None:
            self._req_event(tr, "failed", req, slot=slot,
                            step=self._step_count,
                            error=type(err).__name__,
                            tokens=len(req.generated),
                            attempts=req.attempts)

    def _requeue(self, slot: Optional[int], req: Request, *, ready: int):
        """Slot-safe requeue: tear the slot down, discard the attempt's
        tokens (the retry re-prefills from scratch) and queue at the front,
        eligible from engine step ``ready``."""
        if slot is not None:
            self._teardown(slot)
        req.generated = []
        req.status = "queued"
        req._ready_step = ready
        self.pending.insert(0, req)
        tr = self._tr()
        if tr is not None:
            self._req_event(tr, "retried", req, slot=slot,
                            step=self._step_count, ready=ready,
                            attempt=req.attempts)

    def _dispatch_failure(self, slot: Optional[int], req: Request,
                          err: BaseException):
        """OOM -> the degradation ladder; retryable under the request's
        policy -> requeue with backoff; other typed faults -> fail. Any
        other error is a bug and re-raises."""
        if is_oom(err):
            nxt = req.plan.degrade()
            if nxt is not None:
                req.fallback_chain.append(nxt)
                req.plan = nxt
                tr = self._tr()
                if tr is not None:
                    self._req_event(tr, "degraded", req,
                                    step=self._step_count,
                                    rung=len(req.fallback_chain),
                                    plan=self._plan_label(tr, nxt))
                self._requeue(slot, req, ready=self._step_count + 1)
            else:
                self._fail(slot, req, err)
            return
        if isinstance(err, InjectedFault):
            pol = req.retry
            if pol is not None and pol.should_retry(err, req.attempts):
                delay = pol.delay_steps(req.attempts, seed=req.uid)
                self._requeue(slot, req, ready=self._step_count + delay)
            else:
                self._fail(slot, req, err)
            return
        raise err

    def _poison_slot(self, slot: int):
        """Injected NonFiniteFault: NaN the slot's floating cache rows so
        the guard catches the corruption end to end (a requeued request's
        re-prefill overwrites these rows)."""
        for leaf in tree_leaves(self.cache):
            if leaf.is_floating_point():
                leaf[slot] = float("nan")

    def _next_admissible(self) -> Optional[Request]:
        """Pop the first pending request that is ready (backoff elapsed)
        and fits the memory model (FIFO among eligible)."""
        for i, req in enumerate(self.pending):
            if req._ready_step > self._step_count:
                continue
            if not self._admission(req).fits:
                continue
            return self.pending.pop(i)
        return None

    def _prefill(self, slot: int, req: Request) -> bool:
        """Admit ``req`` into ``slot``. Returns False when a fault rerouted
        the request (requeued or failed) instead."""
        req.attempts += 1
        prompt = torch.as_tensor(req.prompt, dtype=torch.int64,
                                 device=self.device)[None]      # (1, S)
        tr = self._tr()
        if tr is not None:
            self._req_event(tr, "admitted", req, slot=slot,
                            step=self._step_count, attempt=req.attempts,
                            prompt_len=int(req.prompt.shape[-1]),
                            plan=self._plan_label(tr, req.plan))
        try:
            for f in fire("prefill", step=self._step_count, slot=slot,
                          uid=req.uid, attempt=req.attempts, plan=req.plan):
                raise f
            if tr is not None:
                tr.jit_entry("prefill", self._plan_label(tr, req.plan))
            out = obs.timed_call(
                "prefill", _prefill_step, self.params, prompt, cfg=self.cfg,
                plan=req.plan, max_cache_len=self.max_seq,
                attrs={"uid": req.uid, "slot": slot,
                       "prompt_len": int(req.prompt.shape[-1])})
        except Exception as err:
            if not (isinstance(err, InjectedFault) or is_oom(err)):
                raise
            self._dispatch_failure(None, req, err)
            return False
        self._copy_into_slot(slot, out["cache"])
        self.lengths[slot] = len(req.prompt)
        self.slot_req[slot] = req
        req.status = "active"
        if tr is not None:
            self._req_event(tr, "prefill", req, slot=slot,
                            step=self._step_count)
        # the first generated token comes from the prefill logits
        self._emit(slot, out["logits"][0, -1], req)
        return True

    def _copy_into_slot(self, slot: int, cache):
        """Copy a batch-1 prefill's caches and states into ``slot`` (each
        leaf cast to the engine's: a Mamba conv state comes out of the
        prefill in the compute dtype and is kept in fp32). A rolling cache
        holds ``window`` rows while the slot holds ``min(window,
        max_seq)``: where the window is the larger, this raises naming
        both (ROADMAP.md R7; the reference's slot copy fails there
        too)."""
        def copy(full, one):
            if full.shape[1:] != one.shape[1:]:
                raise ValueError(
                    f"{self.cfg.name}: the prefill's cache rows "
                    f"{tuple(one.shape[1:])} do not fit slot rows "
                    f"{tuple(full.shape[1:])}: the sliding window of "
                    f"{self.cfg.sliding_window} tokens exceeds max_seq="
                    f"{self.max_seq} (ROADMAP.md R7)")
            full[slot].copy_(one[0])

        tree_map(copy, self.cache, cache)

    def _admit(self) -> bool:
        admitted = False
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None:
                continue
            req = self._next_admissible()
            if req is None:
                break
            admitted |= self._prefill(slot, req)
        return admitted

    def _expire_deadlines(self):
        now = self._step_count
        for slot, req in enumerate(self.slot_req):
            if req is not None and req._deadline_step is not None \
                    and now > req._deadline_step:
                self._fail(slot, req, DeadlineExceeded(
                    f"request {req.uid}: deadline of {req.deadline} engine "
                    f"steps exceeded while active"))
        for req in [r for r in self.pending if r._deadline_step is not None
                    and now > r._deadline_step]:
            self.pending.remove(req)
            self._fail(None, req, DeadlineExceeded(
                f"request {req.uid}: deadline of {req.deadline} engine "
                f"steps exceeded while queued"))

    def _emit(self, slot: int, logits, req: Request):
        tok = int(sample_token(logits, self._gen, req.temperature))
        req.generated.append(tok)
        obs.count("tokens", slot=slot, uid=req.uid)
        if (req.eos_id is not None and tok == req.eos_id) or \
                len(req.generated) >= req.max_new_tokens:
            self._release(slot, req)

    def _retire_full(self):
        """Force-finish any slot whose sequence reached max_seq: there is
        no cache row left for another decode write."""
        for slot, req in enumerate(self.slot_req):
            if req is not None and int(self.lengths[slot]) >= self.max_seq:
                self._release(slot, req)

    def step(self):
        """One batched decode step across all active slots, one decode
        call per distinct request plan. Returns True when anything
        progressed (decode, admission, release, or a handled failure)."""
        self._step_count += 1
        tr = self._tr()
        if tr is None:
            return self._step_inner(None)
        tr.gauge("queue_depth", len(self.pending), step=self._step_count)
        with tr.span("engine.step", step=self._step_count):
            return self._step_inner(tr)

    def _step_inner(self, tr):
        terminal_before = len(self.finished)
        self._expire_deadlines()
        admitted = self._admit()
        self._retire_full()

        def active_slots():
            return [s for s, r in enumerate(self.slot_req) if r is not None]

        active = active_slots()
        if tr is not None:
            tr.gauge("occupancy", len(active), step=self._step_count)
        if not active:
            return admitted or len(self.finished) != terminal_before

        # Decode-site fault injection, per slot, before the batched call.
        for s in active:
            req = self.slot_req[s]
            for f in fire("decode", step=self._step_count, slot=s,
                          uid=req.uid, attempt=req.attempts, plan=req.plan):
                if isinstance(f, NonFiniteFault):
                    self._poison_slot(s)      # the guard catches it
                else:
                    self._dispatch_failure(s, req, f)
                    break
        active = active_slots()
        if not active:
            return True

        toks = np.zeros((self.n_slots, 1), np.int64)
        for s in active:
            toks[s, 0] = self.slot_req[s].generated[-1]
        toks = torch.as_tensor(toks, device=self.device)
        # Every length lies below max_seq here (``_retire_full``), so each
        # decode write lands inside the cache.
        lengths = torch.as_tensor(self.lengths, dtype=torch.int64,
                                  device=self.device)

        groups: dict[ExecutionPlan, list[int]] = {}
        for s in active:
            groups.setdefault(self.slot_req[s].plan, []).append(s)

        logits_by_slot: dict[int, torch.Tensor] = {}
        finite_by_slot: dict[int, bool] = {}
        decoded: list[int] = []
        failed_groups = 0
        for plan_, slots in groups.items():
            try:
                if tr is not None:
                    label = self._plan_label(tr, plan_)
                    tr.jit_entry("decode", label)
                    out, finite = tr.timed_call(
                        "decode", _decode_step, self.params, toks,
                        self.cache, lengths, cfg=self.cfg, plan=plan_,
                        attrs={"plan": label, "batch": len(slots),
                               "step": self._step_count})
                else:
                    out, finite = _decode_step(
                        self.params, toks, self.cache, lengths,
                        cfg=self.cfg, plan=plan_)
            except Exception as err:
                if not is_oom(err):
                    raise
                failed_groups += 1
                for s in slots:
                    self._dispatch_failure(s, self.slot_req[s], err)
                continue
            if len(groups) == 1 and not failed_groups:
                self.cache = out["cache"]
            else:
                # Each group's rows, cast to the engine's leaf as the
                # reference's ``.at[].set`` casts (a Mamba conv state
                # comes out of decode in the compute dtype).
                idx = torch.as_tensor(slots, device=self.device)
                tree_map(lambda acc, new: acc.index_copy_(
                    0, idx, new.index_select(0, idx).to(acc.dtype)),
                    self.cache, out["cache"])
            finite = finite.cpu().numpy()
            logits = out["logits"][:, 0]
            for s in slots:
                logits_by_slot[s] = logits[s]
                finite_by_slot[s] = bool(finite[s])
            decoded.extend(slots)
        self.lengths = self.lengths + np.asarray(
            [1 if (s in decoded and self.slot_req[s] is not None) else 0
             for s in range(self.n_slots)], np.int32)
        for s in decoded:
            req = self.slot_req[s]
            if req is None:
                continue
            if not finite_by_slot[s]:
                # Quarantine only this slot: the rest of the batch is
                # untouched.
                if tr is not None:
                    self._req_event(tr, "quarantined", req, slot=s,
                                    step=self._step_count)
                self._dispatch_failure(s, req, NonFiniteFault(
                    f"request {req.uid}: non-finite logits in decode group "
                    f"— slot {s} quarantined",
                    site="decode", step=self._step_count, slot=s,
                    uid=req.uid))
                continue
            if tr is not None:
                tr.count("tokens_decoded", slot=s, uid=req.uid)
            self._emit(s, logits_by_slot[s], req)
        return True

    def run(self):
        """Drain all pending and active requests; returns the terminal
        Requests (``status`` 'done' or 'failed'). A non-empty queue that
        can make no progress fails typed instead of spinning."""
        with obs.span("engine.run"):
            return self._run_inner()

    def _run_inner(self):
        while self.pending or any(r is not None for r in self.slot_req):
            progressed = self.step()
            if progressed:
                continue
            if not self.pending:
                break
            if any(r._ready_step > self._step_count for r in self.pending):
                continue      # backoff timers still counting down
            for req in list(self.pending):
                self.pending.remove(req)
                self._fail(None, req, AdmissionError(
                    f"request {req.uid} can never be admitted: "
                    f"{self._admission(req).describe()}"))
        return self.finished
