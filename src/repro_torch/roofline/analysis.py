"""Roofline analysis of a PyTorch program, counted as it runs (no device
needed: the dry-run runs it on fake tensors).

The port's counterpart of the reference's ``roofline/analysis.py``. Three
terms per program, all in seconds:

  compute    = FLOPs / (chips * peak_FLOP/s)
  memory     = HBM_bytes / (chips * HBM_bw)
  collective = wire_bytes / (chips * link_bw)

The reference reads FLOPs and HBM bytes from compiled XLA (``hlo_cost``)
and the collectives from its HLO text (``parse_collectives``), scaling the
ops of while-loop bodies by their trip counts. PyTorch has no HLO. Here:

* ``counting()`` runs the program once under a ``TorchDispatchMode`` that
  counts what each aten op does: the FLOPs of its matrix products (mm,
  bmm, addmm, baddbmm, at 2·M·N·K, the reference's "only dots") and, as
  HBM bytes, its inputs plus its outputs (the reference's "I/O of
  top-level ops"). Views move no bytes; an input read through a stride-0
  (broadcast) axis counts its distinct elements once.
* The port's fused ops are CUDA kernels launched through ``ctypes``, which
  no dispatch mode sees. So each entry point of ``kernels/ops.py``, and
  each backward ``Function`` there, reports its own work at its boundary
  while counting is on (``counted``, ``Counter.call``): FLOPs are its
  matrix products, bytes its inputs and outputs once, and what runs inside
  it is not counted again. The cost functions below (``layer_norm_cost``
  ...) are the one source of those numbers, for the path's roofline and
  for the kernel table's bounds alike. The count thus reads the same work
  whichever implementation runs, the kernel on the card or the plain
  version on the CPU.
* An eager program executes every call, so nothing is scaled by trip
  counts. The collectives come from ``core.dist.collectives()``, whose
  bytes are already what a rank sends (``collective_stats``).

When counting is off, an entry point pays one read of a module global
(``active``), not a contextvar: autograd runs a CUDA backward, and a
checkpoint's recompute inside it, on its own thread, which sees no
contextvar of the caller's. Its output is the same, bit for bit.

Left out of the reference: its HLO text helpers (``_split_computations``,
``_execution_scales``, ``_symbols``, ``_dot_flops``, ``_line_io_bytes``,
``_fusion_*``, ``_op_bytes``, ``cost_scale_factor``), which read a
compiled XLA program that PyTorch does not make. ``DTYPE_BYTES`` is the
counterpart of its ``_shape_bytes``.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DTYPE_BYTES = {
    torch.float64: 8, torch.float32: 4, torch.float16: 2, torch.bfloat16: 2,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int64: 8, torch.int32: 4, torch.int16: 2, torch.int8: 1,
    torch.uint8: 1, torch.bool: 1, torch.complex64: 8, torch.complex128: 16,
}

# wire factor per participant for ring algorithms (group size n):
_WIRE_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,       # payload = full output
    "reduce-scatter": lambda n: (n - 1) / n,   # payload = full input
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# core.dist's kinds by the reference's HLO names.
_KIND = {"all_to_all": "all-to-all", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce"}
# core.dist counts an all-reduce once as itself and once more as its two
# halves, under this pass; the halves are left out here.
_HALVES = "all_reduce"


def shape_bytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * DTYPE_BYTES[dtype]


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` reads: a stride-0
    (broadcast) axis counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def io_bytes(*ts) -> int:
    return sum(tensor_bytes(t) for t in ts if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# The fused ops' own work
# ---------------------------------------------------------------------------

class OpCost(NamedTuple):
    """One call's work: ``flops`` of its matrix products (the roofline's
    count), ``ops`` the operations its bound counts (its FLOPs where it is
    a product, else its arithmetic per element), run at the peak of
    ``dtype``, and ``bytes`` its inputs read and outputs written once."""
    flops: float
    ops: float
    bytes: int
    dtype: str


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def layer_norm_cost(x, gamma, beta, eps: float = 1e-5) -> OpCost:
    """K1: x in, x-shaped out; 8 operations an element in fp32."""
    return OpCost(0.0, 8.0 * x.numel(),
                  io_bytes(x, gamma, beta) + shape_bytes(x.shape, x.dtype),
                  "float32")


def bias_sigmoid_mul_cost(g, bg, v) -> OpCost:
    """K2: sigmoid(g + bg) * v; 6 operations an element in fp32."""
    return OpCost(0.0, 6.0 * v.numel(),
                  io_bytes(g, bg, v) + shape_bytes(v.shape, v.dtype),
                  "float32")


def softmax_cost(x, bias=None, mask=None, scale: float = 1.0) -> OpCost:
    """K4: the softmax of x's rows; 8 operations an element in fp32."""
    return OpCost(0.0, 8.0 * x.numel(),
                  io_bytes(x, bias, mask) + shape_bytes(x.shape, x.dtype),
                  "float32")


def _attn_dims(q, k):
    """(N, Sq, H, D, Skv) of the 4D or 5D form."""
    *lead, sq, h, d = q.shape
    n = 1
    for s in lead:
        n *= s
    return n, sq, h, d, k.shape[-3]


def attention_cost(q, k, v, *, bias=None, mask=None, scale=None,
                   kv_tile: int = 0) -> OpCost:
    """K5: the QK^T and PV products; out (q's shape and dtype) and the fp32
    lse (N, H, Sq) written."""
    n, sq, h, d, skv = _attn_dims(q, k)
    flops = 4.0 * n * h * sq * skv * d
    return OpCost(flops, flops,
                  io_bytes(q, k, v, bias, mask) + shape_bytes(q.shape, q.dtype)
                  + 4 * n * h * sq, _dt(q))


def attention_bwd_cost(q, k, v, out, do, lse, bias, mask, grads) -> OpCost:
    """K6: the least work, five S x S x D products (s, dp, dv, dq, dk);
    ``grads`` the gradients it writes."""
    n, sq, h, d, skv = _attn_dims(q, k)
    flops = 10.0 * n * h * sq * skv * d
    return OpCost(flops, flops,
                  io_bytes(q, k, v, out, do, lse, bias, mask, *grads), _dt(q))


def triangle_cost(a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
                  g_bias, *, eps: float = 1e-5, tile: int = 0) -> OpCost:
    """K7: the k product and the C→D projection; out (g_lin's shape and
    dtype) and the fp32 LN mean and inv (B, I, J) written."""
    bsz, ni, nk, c = a_lin.shape
    nj, d = b_full.shape[1], w_out.shape[1]
    flops = 2.0 * bsz * ni * nj * c * (nk + d)
    out = shape_bytes(g_lin.shape, g_lin.dtype) + 2 * 4 * bsz * ni * nj
    return OpCost(flops, flops,
                  io_bytes(a_lin, ga, mask, b_full, gamma, beta, w_out, b_out,
                           g_lin, g_bias) + out, _dt(a_lin))


def opm_cost(a, b_full, mask_a, mask_b, w, bias, *, tile: int = 0) -> OpCost:
    """K8: the outer product with its mask norm, and the C²→D projection;
    out (B, I, J, D) in a's dtype written."""
    bsz, ns, ni, c = a.shape
    nj, d = b_full.shape[2], w.shape[1]
    flops = (2.0 * bsz * ni * nj * ns * (c * c + 1)
             + 2.0 * bsz * ni * nj * c * c * d)
    return OpCost(flops, flops,
                  io_bytes(a, b_full, mask_a, mask_b, w, bias)
                  + shape_bytes((bsz, ni, nj, d), a.dtype), _dt(a))


def bias_dropout_add_cost(x, b, residual, rate: float = 0.0,
                          keep=None) -> OpCost:
    """K3: residual + dropout(x + b); 4 operations an element in fp32."""
    if keep is None or rate == 0.0:
        keep = None
    return OpCost(0.0, 4.0 * x.numel(),
                  io_bytes(x, b, residual, keep)
                  + shape_bytes(x.shape, residual.dtype), "float32")


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
# Ops that move no bytes: allocation, reshape of a fresh tensor, scalars.
_FREE = {_aten._unsafe_view.default, _aten.empty.memory_format,
         _aten.empty_like.default, _aten.empty_strided.default,
         _aten.new_empty.default, _aten.new_empty_strided.default,
         _aten._local_scalar_dense.default, _aten.lift_fresh.default,
         _aten.set_.source_Storage_storage_offset, _aten.resize_.default}
# In-place ops that write their first argument without reading it.
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _matmul_flops(func, args) -> float:
    a, b = args[-2], args[-1]
    if func is _aten.addmm.default or func is _aten.baddbmm.default:
        a, b = args[1], args[2]
    return 2.0 * a.numel() * b.shape[-1]


_NO_BYTES: dict = {}
_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` is an aten op implemented by other aten ops."""
    comp = _COMPOSITE.get(func)
    if comp is None:
        comp = (func.namespace == "aten" and func not in _MATMULS
                and torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(),
                    torch._C.DispatchKey.CompositeImplicitAutograd))
        _COMPOSITE[func] = comp
    return comp


def _moves_no_bytes(func) -> bool:
    """Allocation, scalars, ops outside aten (collectives), and views: an
    op whose every output aliases an input without writing it."""
    free = _NO_BYTES.get(func)
    if free is None:
        rets = func._schema.returns
        free = (func in _FREE or func.namespace != "aten"
                or (bool(rets) and all(
                    r.alias_info is not None and not r.alias_info.is_write
                    for r in rets)))
        _NO_BYTES[func] = free
    return free


@dataclass(eq=False)
class Storage:
    """A storage the memory tracker saw: its ``nbytes`` (0 for one that
    existed before the run), the ``tag`` that says what it stands for, and
    ``event``, the place of its allocation among the run's events."""
    nbytes: int
    tag: object = None
    event: int = -1


class Memory(NamedTuple):
    """Bytes alive: at the peak, as the run's last backward op ended (0
    without one), and at the end of the run."""
    peak: float
    at_backward_end: float
    at_end: float


@dataclass
class Counter:
    """What a counted run did. ``flops`` and ``hbm_bytes`` as the module's
    doc counts them, ``by_op`` {name: [calls, flops, bytes]}; with
    ``memory``, every allocation and release of a storage, in order, which
    ``live_bytes`` replays."""

    memory: bool = False
    flops: float = 0.0
    hbm_bytes: float = 0.0
    by_op: dict = field(default_factory=dict)
    _quiet: int = 0
    _quiet_flops: int = 0
    _storages: weakref.WeakKeyDictionary = field(
        default_factory=weakref.WeakKeyDictionary)
    _events: list = field(default_factory=list)
    _backward_end: int = -1

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0.0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def exclude(self, trees) -> None:
        """The storages of the tensors in ``trees`` (nested dicts, lists
        and tuples) exist already: they, and views of them, count 0 bytes."""
        for t in _leaves(trees):
            self._record(t, 0)

    def tag(self, t: torch.Tensor, tag) -> None:
        """Say what ``t``'s storage stands for. A storage the run makes
        takes the tag of the first of its op's inputs that has one and as
        many elements, unless it is given its own."""
        self._record(t)[0].tag = tag

    def _record(self, t: torch.Tensor, nbytes: int | None = None):
        """(the ``Storage`` of ``t``, whether it is new)."""
        st = t.untyped_storage()
        rec = self._storages.get(st)
        if rec is not None:
            return rec, False
        rec = Storage(st.nbytes() if nbytes is None else nbytes)
        self._storages[st] = rec
        if rec.nbytes:
            rec.event = len(self._events)
            self._events.append((rec, 1))
            weakref.finalize(st, self._events.append, (rec, -1))
        return rec, True

    def _made(self, ins, outs) -> None:
        """Record ``outs``, the tensors an op returned, ``ins`` its inputs."""
        tagged = None
        for t in outs:
            rec, new = self._record(t)
            if not new or rec.tag is not None:
                continue
            if tagged is None:
                tagged = [(x.numel(), r.tag) for x in ins
                          if (r := self._storages.get(x.untyped_storage()))
                          is not None and r.tag is not None]
            rec.tag = next((tag for n, tag in tagged if n == t.numel()),
                           None)
        if torch._C._current_graph_task_id() != -1:
            self._backward_end = len(self._events)

    def live_bytes(self, weigh=None) -> Memory:
        """The recorded allocations replayed, each storage's bytes times
        ``weigh(tag, after_backward)`` where that is given (the share of it
        one device holds, say): ``after_backward`` says the storage was
        made after the run's last backward op."""
        live = peak = at_backward = 0.0
        share = {}
        for k, (rec, sign) in enumerate(self._events):
            if k == self._backward_end:
                at_backward = live
            w = share.get(id(rec))
            if w is None:
                w = share[id(rec)] = 1.0 if weigh is None else weigh(
                    rec.tag, 0 <= self._backward_end <= rec.event)
            live += sign * rec.nbytes * w
            peak = max(peak, live)
        if self._backward_end == len(self._events):
            at_backward = live
        return Memory(peak, at_backward, live)

    def call(self, name: str, fn, *args, cost=None, inner_flops=False):
        """``fn(*args)`` counted as one op: ``cost(result)`` gives its
        ``OpCost``, or, where ``cost`` is None, its bytes are ``args``'
        tensors and the result's. What runs inside is not counted, except
        its matrix products where ``inner_flops``."""
        self._quiet += 1
        self._quiet_flops += not inner_flops
        before = self.flops
        try:
            out = fn(*args)
        finally:
            self._quiet -= 1
            self._quiet_flops -= not inner_flops
        inner = self.flops - before
        if cost is None:
            self.add(name, 0.0, io_bytes(*_tensors(args), *_tensors(
                out if isinstance(out, (list, tuple)) else (out,))))
        else:
            c = cost(out)
            self.add(name, c.flops, c.bytes)
        if inner:
            self.by_op[name][1] += inner
        return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


class _CountMode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # Under inference_mode a composite op (einsum, matmul, linear)
            # arrives whole; counted as the ops it runs, as with autograd.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.counter
        fl = 0.0
        if not c._quiet_flops and func in _MATMULS:
            fl = _matmul_flops(func, args)
            c.flops += fl
        if not c._quiet and not _moves_no_bytes(func):
            ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
            nb = io_bytes(*ins, *_tensors(
                out if isinstance(out, (list, tuple)) else (out,)))
            if func in _WRITE_ONLY:
                nb -= tensor_bytes(args[0])
            c.hbm_bytes += nb
            row = c.by_op.setdefault(func.__name__, [0, 0.0, 0])
            row[0] += 1
            row[1] += fl
            row[2] += nb
        if c.memory:
            c._made(list(_tensors(args)), list(_tensors(
                out if isinstance(out, (list, tuple)) else (out,))))
        return out


_ACTIVE: Counter | None = None


def active() -> Counter | None:
    """The counter of the ``counting()`` scope in force, else None."""
    return _ACTIVE


@contextlib.contextmanager
def counting(*, memory: bool = False, exclude=()):
    """Count what runs inside: ``with counting() as c: ...`` then
    ``c.flops``, ``c.hbm_bytes``. ``memory`` also records the storages the
    run makes (``c.live_bytes()``), those of ``exclude`` (trees of tensors
    that exist already) left out. One scope at a time."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("roofline.analysis.counting() is already active")
    counter = Counter(memory=memory)
    if memory:
        counter.exclude(exclude)
    _ACTIVE = counter
    try:
        with _CountMode(counter):
            yield counter
    finally:
        _ACTIVE = None


def count_cost(fn, *args, **kwargs) -> tuple[float, float]:
    """(flops, hbm_bytes) of one call of ``fn(*args, **kwargs)``."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.flops, c.hbm_bytes


def counted(name: str, cost):
    """Decorate a fused op's entry point so that, while counting, it
    reports ``cost(*args, **kwargs)`` and nothing inside it is counted."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            c = _ACTIVE
            if c is None:
                return fn(*args, **kwargs)
            return c.call(name, lambda: fn(*args, **kwargs),
                          cost=lambda _: cost(*args, **kwargs))
        return entry
    return wrap


def counted_call(name: str, fn, *args, cost=None, inner_flops=False):
    """``fn(*args)``, reported as one op while counting (``Counter.call``)."""
    c = _ACTIVE
    if c is None:
        return fn(*args)
    return c.call(name, fn, *args, cost=cost, inner_flops=inner_flops)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    payload_bytes: dict = field(default_factory=dict)
    wire_bytes: float = 0.0


def collective_stats(log: dict, group_size: int) -> CollectiveStats:
    """The collectives of ``core.dist.collectives()``'s log ({kind: {pass:
    {"calls", "bytes"}}}, every executed call) by the reference's names.
    The log's bytes are what a rank sends, i.e. the reference's payload
    times ``_WIRE_FACTOR`` for a group of ``group_size``: they are the wire
    bytes, and the payload is recovered from them. An all-reduce counts
    once (its two halves, logged under the pass "all_reduce", do not)."""
    stats = CollectiveStats()
    n = max(group_size, 2)
    for kind, passes in log.items():
        op = _KIND[kind]
        for phase, v in passes.items():
            if phase == _HALVES:
                continue
            stats.counts[op] = stats.counts.get(op, 0) + v["calls"]
            stats.payload_bytes[op] = (stats.payload_bytes.get(op, 0.0)
                                       + v["bytes"] / _WIRE_FACTOR[op](n))
            stats.wire_bytes += v["bytes"]
    return stats


def count_collective_ops(log: dict, blocks: int = 1) -> dict[str, float]:
    """Collectives per block: the executed calls of ``log`` divided by
    ``blocks`` (the reference counts its scan body once, statically)."""
    return {op: calls / blocks
            for op, calls in collective_stats(log, 2).counts.items()}


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    chips: int
    peak_flops: float
    hbm_bw: float
    ici_bw: float

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / (self.chips * self.ici_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def model_flops(shape, n_params_active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference forward)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params_active * tokens
