"""Distribution backends of the Evoformer for Dynamic Axial Parallelism
(paper §IV.B): the port's counterpart of the reference's ``core/dist.py``.

The Evoformer is written once against this interface; the backends give its
execution modes:

* ``LocalDist`` — one device: every collective is the identity. The
  reference's ``LocalDist``.
* ``ProcessGroupDist`` — DAP over a ``torch.distributed`` process group with
  explicit collectives, the reference's ``ShardMapDist``: the MSA and pair
  activations are sharded on one axis (``core/dap.py``), ``all_to_all``
  moves the shard from one axis to another where the paper's Fig. 6 places
  it, and ``all_gather`` materialises the operands that cross the sharded
  axis (the pair biases, the outer-product-mean's right projection, the
  triangle updates' gated b). ``axis_size`` is the group's size.
* ``WholeModelDist`` — the whole AlphaFold model under DAP, the role of the
  reference's ``GspmdDist``. PyTorch has no GSPMD, so the port inserts
  explicitly the collectives that GSPMD inserts for ``GspmdDist``: the
  embedding, structure module, heads and loss run on every rank on the
  whole batch, the Evoformer stack takes its inputs' shards at entry
  (``scatter``) and gathers its outputs at exit (``gather``), and the
  Evoformer's parameters enter it through ``sync_grads``.

Each collective is a ``torch.autograd.Function`` whose backward is its dual:
``all_to_all`` (split a, concatenate c) ↔ ``all_to_all`` (split c,
concatenate a), ``all_gather`` ↔ a reduce-scatter, ``scatter`` ↔
``all_gather``, ``gather`` ↔ the rank's own slice, ``sync_grads`` (the
identity) ↔ an all-reduce of the gradients. The reduce-scatter is an
all-to-all followed by a sum over the chunk axis, and the all-reduce a
reduce-scatter followed by an all-gather, on every backend: one code path
for gloo and NCCL, and every rank ends with the same bits, each sum taken in
rank order on one rank. Only ``all_to_all_single`` and the list form of
``all_gather`` reach ``torch.distributed``. A collective's output lies in
memory in the order of its input's dimensions, so with one rank each
collective hands on exactly what ``LocalDist`` hands on, layout included.

``COLLECTIVES`` counts each rank's collectives by kind and pass ("forward",
"backward"; "stack entry" and "stack exit" for the whole model's scatter
and gather, "all_reduce" for the two halves of an all-reduce, which also
counts once as itself) with the bytes the rank sends to the others: an all-to-all
(N - 1)/N of its input, an all-gather N - 1 times its shard, a
reduce-scatter (N - 1)/N of its input, an all-reduce 2 (N - 1)/N of its
tensor.

The ``sharded_*`` hooks run the Evoformer's fused kernels on the tensors in
hand, which are local under both backends: ``ops.fused_attention`` on
(B, G/N, S, H, D) blocks with the gathered (B, H, S, S) bias,
``ops.fused_triangle_mult`` on (B, I/N, K, C) rows with the gathered
(B, J, K, C) b, and ``ops.fused_outer_product_mean`` on (B, S, I/N, C)
columns with the gathered (B, S, J, C) right projection.

A backend raises only for a layout it cannot take: an extent the group's
size does not divide raises ``ValueError`` naming both. ``form_group``
joins a process group through a file store and gives the rank its device;
``run_ranks`` spawns one process a rank and fails when any of them fails
or hangs.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, ClassVar

import torch
import torch.distributed as tdist

from repro_torch.kernels import ops

# kind -> pass -> {"calls", "bytes"}: the collectives of each rank.
COLLECTIVES: dict[str, dict[str, dict[str, int]]] = {}
# The result shape of each all-gather the rank ran, in order.
GATHER_SHAPES: list[tuple[int, ...]] = []


def reset_collectives() -> None:
    COLLECTIVES.clear()
    GATHER_SHAPES.clear()


def collectives() -> dict:
    """A copy of the counts, {kind: {pass: {"calls": n, "bytes": b}}}."""
    return {k: {p: dict(v) for p, v in ps.items()}
            for k, ps in COLLECTIVES.items()}


def collective_shapes() -> list[tuple[int, ...]]:
    """The result shape of every all-gather run since the last
    ``reset_collectives``, in order (those of an all-reduce's second half
    too): what ``analysis.contracts.NoMergedAllGather`` reads."""
    return list(GATHER_SHAPES)


def _count(kind: str, phase: str, nbytes: float) -> None:
    c = COLLECTIVES.setdefault(kind, {}).setdefault(
        phase, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += int(nbytes)


def check_layout(axis_size: int, **extents: int) -> None:
    """Raise ValueError unless ``axis_size`` divides every extent."""
    bad = {k: v for k, v in extents.items() if v % axis_size}
    if bad:
        raise ValueError(
            f"DAP over {axis_size} ranks cannot shard "
            + ", ".join(f"{k}={v}" for k, v in bad.items())
            + f": the group's size {axis_size} must divide each")


class _KernelHooks:
    """The ``sharded_*`` hooks: the tensors in hand are local under every
    backend of the port, so each hook calls the fused op as it is."""

    local_tensors: ClassVar[bool] = True

    def sharded_attention_supported(self, q_shape) -> bool:
        return True

    def sharded_attention(self, q, k, v, *, bias=None, mask=None, scale=None,
                          kv_tile=0):
        return ops.fused_attention(q, k, v, bias=bias, mask=mask, scale=scale,
                                   kv_tile=kv_tile)

    def sharded_triangle_supported(self, i_extent: int) -> bool:
        return True

    def sharded_triangle(self, a_lin, ga, mask, b_full, gamma, beta, w_out,
                         b_out, g_lin, g_bias, *, tile=0):
        return ops.fused_triangle_mult(a_lin, ga, mask, b_full, gamma, beta,
                                       w_out, b_out, g_lin, g_bias, tile=tile)

    def sharded_opm_supported(self, i_extent: int) -> bool:
        return True

    def sharded_opm(self, a, b_full, mask_a, mask_b, w, bias, *, tile=0):
        return ops.fused_outer_product_mean(a, b_full, mask_a, mask_b, w,
                                            bias, tile=tile)


@dataclass(frozen=True)
class LocalDist(_KernelHooks):
    """Identity backend (one DAP device)."""

    axis_size: int = 1
    rank: ClassVar[int] = 0
    whole_model: ClassVar[bool] = False

    def all_to_all(self, x, *, split_axis: int, concat_axis: int):
        return x

    def all_gather(self, x, *, axis: int):
        return x

    def psum_scatter(self, x, *, axis: int):
        return x

    def all_reduce(self, x):
        return x

    def copy_to_ranks(self, x):
        return x

    def constrain(self, x, dims):
        return x

    def shard(self, x, *, axis: int):
        return x

    def scatter(self, x, *, axis: int):
        return x

    def gather(self, x, *, axis: int):
        return x

    def sync_grads(self, tensors):
        return tensors

    def check_layout(self, **extents: int) -> None:
        pass


# ---------------------------------------------------------------------------
# Collectives on a process group
# ---------------------------------------------------------------------------

def _empty_like_layout(x: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` whose dimensions lie in memory in the
    order of ``x``'s (``empty_like`` where the shapes agree)."""
    if tuple(shape) == tuple(x.shape):
        return torch.empty_like(x)
    order = sorted(range(x.ndim), key=lambda d: (-x.stride(d), d))
    t = x.new_empty([shape[d] for d in order])
    return t.permute([order.index(d) for d in range(x.ndim)])


def _chunks_first(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """x with ``axis`` split into n chunks, the chunk index moved to the
    front, contiguous: the send buffer of an all-to-all."""
    return x.unflatten(axis, (n, x.shape[axis] // n)).movedim(
        axis, 0).contiguous()


def _place_chunks(recv: torch.Tensor, like: torch.Tensor, axis: int,
                  shape) -> torch.Tensor:
    """The (n, ...) received chunks concatenated along ``axis`` in rank
    order, into a tensor of ``shape`` laid out like ``like``."""
    n = recv.shape[0]
    out = _empty_like_layout(like, shape)
    out.unflatten(axis, (n, shape[axis] // n)).movedim(axis, 0).copy_(recv)
    return out


class Pending:
    """A launched collective: ``wait()`` waits for it and returns its result.
    The input and the receive buffer are held until then, so that neither
    is freed, nor its memory reused, while the collective may still read or
    write it. They are released only after ``work.wait()``, which orders
    the current CUDA stream after the collective's, so the caching
    allocator reuses their memory only behind it and no ``record_stream``
    is needed."""

    __slots__ = ("work", "recv", "finish", "keep")

    def __init__(self, work, recv, finish, keep):
        self.work, self.recv, self.finish, self.keep = work, recv, finish, keep

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        out = self.finish(self.recv)
        self.work = self.recv = self.finish = self.keep = None
        return out


def _dual(kind: str, kw: dict) -> tuple[str, dict]:
    """The collective that carries a collective's gradient back."""
    if kind == "all_to_all":
        return kind, {"split_axis": kw["concat_axis"],
                      "concat_axis": kw["split_axis"]}
    if kind == "all_gather":
        return "reduce_scatter", kw
    if kind == "reduce_scatter":
        return "all_gather", kw
    raise ValueError(f"no dual for {kind!r}")


class _Collective(torch.autograd.Function):
    """A synchronous collective whose backward is its dual."""

    @staticmethod
    def forward(ctx, x, dist, kind, kw):
        ctx.dist, ctx.kind, ctx.kw = dist, kind, kw
        return dist.start(kind, x, **kw).wait()

    @staticmethod
    def backward(ctx, g):
        kind, kw = _dual(ctx.kind, ctx.kw)
        return (ctx.dist.start(kind, g, phase="backward", **kw).wait(), None,
                None, None)


class _Scatter(torch.autograd.Function):
    """Forward: the rank's slice of a tensor that every rank holds whole;
    backward: the all-gather of the slices' gradients."""

    @staticmethod
    def forward(ctx, x, dist, axis):
        ctx.dist, ctx.axis = dist, axis
        return dist.shard(x, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return (ctx.dist.start("all_gather", g, axis=ctx.axis,
                               phase="stack entry").wait(), None, None)


class _Gather(torch.autograd.Function):
    """Forward: the all-gather of the shards; backward: the rank's slice of
    the gradient, which every rank holds whole (the loss is computed on
    every rank from the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, dist, axis):
        ctx.dist, ctx.axis = dist, axis
        return dist.start("all_gather", x, axis=axis,
                          phase="stack exit").wait()

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.shard(g, axis=ctx.axis), None, None


class _AllReduceForward(torch.autograd.Function):
    """Megatron's g: the all-reduce after a row-parallel product; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, dist):
        return dist.all_reduce_tensor(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBackward(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward all-reduces the
    gradient (a replicated input entering a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.dist.all_reduce_tensor(g, phase="backward"), None


class _SyncGrads(torch.autograd.Function):
    """The identity on a list of tensors forward; backward, one all-reduce
    (sum) of all their gradients, flattened into one buffer. Each gradient
    comes back in a tensor of its own."""

    @staticmethod
    def forward(ctx, dist, *ts):
        ctx.dist = dist
        ctx.meta = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
              for g, (s, dt, dev) in zip(gs, ctx.meta)]
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        flat = ctx.dist.all_reduce_tensor(flat, phase="backward")
        out, o = [], 0
        for g in gs:
            out.append(flat[o:o + g.numel()].view(g.shape).to(g.dtype,
                                                              copy=True))
            o += g.numel()
        return (None, *out)


@dataclass(frozen=True, eq=False)
class ProcessGroupDist(_KernelHooks):
    """Explicit-collective DAP on a ``torch.distributed`` process group
    (``group=None``: the default group). Tensors in hand are the rank's
    shards."""

    group: Any = None
    whole_model: ClassVar[bool] = False

    def __post_init__(self):
        if not tdist.is_available() or not tdist.is_initialized():
            raise RuntimeError(
                f"{type(self).__name__} needs an initialised "
                "torch.distributed process group (core.dist.form_group)")

    @property
    def axis_size(self) -> int:
        return tdist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return tdist.get_rank(self.group)

    def check_layout(self, **extents: int) -> None:
        check_layout(self.axis_size, **extents)

    def _split(self, x: torch.Tensor, axis: int, what: str) -> int:
        n = self.axis_size
        if x.shape[axis] % n:
            raise ValueError(
                f"{what}: axis {axis} of {tuple(x.shape)} has extent "
                f"{x.shape[axis]}, which the group's size {n} does not "
                "divide")
        return n

    # -- the primitive collectives ---------------------------------------

    def start(self, kind: str, x: torch.Tensor, *, async_op: bool = False,
              phase: str = "forward", **kw) -> Pending:
        """Launch one collective; ``Pending.wait()`` gives its result.

        kind "all_to_all" (``split_axis``, ``concat_axis``): split
        ``split_axis`` into N chunks, chunk j to rank j, the chunks received
        concatenated along ``concat_axis`` in rank order. "all_gather"
        (``axis``): the ranks' tensors concatenated along ``axis``.
        "reduce_scatter" (``axis``): ``axis`` split into N chunks, chunk j
        summed over the ranks on rank j."""
        g = self.group
        if kind == "all_to_all":
            a, c = kw["split_axis"], kw["concat_axis"]
            n = self._split(x, a, "all_to_all")
            send = _chunks_first(x, a, n)
            recv = torch.empty_like(send)
            work = tdist.all_to_all_single(recv, send, group=g,
                                           async_op=async_op)
            shape = list(x.shape)
            shape[a] //= n
            shape[c] *= n
            _count(kind, phase, x.numel() * x.element_size() * (n - 1) / n)
            return Pending(work, recv,
                           lambda r: _place_chunks(r, x, c, shape), send)
        if kind == "all_gather":
            axis, n = kw["axis"], self.axis_size
            xc = x.contiguous()
            recv = x.new_empty((n,) + tuple(xc.shape))
            work = tdist.all_gather(list(recv.unbind(0)), xc, group=g,
                                    async_op=async_op)
            shape = list(x.shape)
            shape[axis] *= n
            _count(kind, phase, xc.numel() * xc.element_size() * (n - 1))
            GATHER_SHAPES.append(tuple(shape))
            return Pending(work, recv,
                           lambda r: _place_chunks(r, x, axis, shape), xc)
        if kind == "reduce_scatter":
            axis = kw["axis"]
            n = self._split(x, axis, "reduce_scatter")
            send = _chunks_first(x, axis, n)
            recv = torch.empty_like(send)
            work = tdist.all_to_all_single(recv, send, group=g,
                                           async_op=async_op)
            shape = list(x.shape)
            shape[axis] //= n
            _count(kind, phase, x.numel() * x.element_size() * (n - 1) / n)

            def finish(r):
                out = _empty_like_layout(x, shape)
                return out.copy_(r.sum(0))

            return Pending(work, recv, finish, send)
        raise ValueError(f"unknown collective {kind!r}")

    def all_reduce_tensor(self, x: torch.Tensor, *,
                          phase: str = "forward") -> torch.Tensor:
        """The sum over the ranks, bit-identical on every rank: a
        reduce-scatter of x's flat padded to N chunks (each chunk summed in
        rank order on one rank), then an all-gather. Not differentiable;
        ``all_reduce`` is."""
        n = self.axis_size
        flat = x.reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = self.start("reduce_scatter", flat, axis=0,
                          phase="all_reduce").wait()
        full = self.start("all_gather", part, axis=0,
                          phase="all_reduce").wait()
        _count("all_reduce", phase,
               2 * x.numel() * x.element_size() * (n - 1) / n)
        out = _empty_like_layout(x, x.shape)
        return out.copy_(full[:x.numel()].view(x.shape))

    # -- the differentiable interface of the Evoformer --------------------

    def all_to_all(self, x, *, split_axis: int, concat_axis: int):
        return _Collective.apply(x, self, "all_to_all",
                                 {"split_axis": split_axis,
                                  "concat_axis": concat_axis})

    def all_gather(self, x, *, axis: int):
        return _Collective.apply(x, self, "all_gather", {"axis": axis})

    def psum_scatter(self, x, *, axis: int):
        return _Collective.apply(x, self, "reduce_scatter", {"axis": axis})

    def all_reduce(self, x):
        """Megatron's g: all-reduce forward, identity backward."""
        return _AllReduceForward.apply(x, self)

    def copy_to_ranks(self, x):
        """Megatron's f: identity forward, all-reduce backward."""
        return _AllReduceBackward.apply(x, self)

    def constrain(self, x, dims):
        return x

    def shard(self, x, *, axis: int):
        """The rank's slice of ``axis``, contiguous (not differentiable
        through the group: use ``scatter``)."""
        n = self._split(x, axis, "shard")
        size = x.shape[axis] // n
        return x.narrow(axis, self.rank * size, size).contiguous()

    def scatter(self, x, *, axis: int):
        return _Scatter.apply(x, self, axis)

    def gather(self, x, *, axis: int):
        return _Gather.apply(x, self, axis)

    def sync_grads(self, tensors):
        """The identity on a list of tensors whose gradients are all-reduced
        (summed over the ranks) in the backward."""
        tensors = list(tensors)
        if not torch.is_grad_enabled() or not any(t.requires_grad
                                                  for t in tensors):
            return tensors
        return list(_SyncGrads.apply(self, *tensors))


@dataclass(frozen=True, eq=False)
class WholeModelDist(ProcessGroupDist):
    """The whole model under DAP (the reference's ``GspmdDist`` role): the
    model takes whole tensors on every rank; the Evoformer stack scatters
    and gathers them (``core.alphafold.alphafold_iteration``)."""

    whole_model: ClassVar[bool] = True


def dist_from_policy(policy):
    """The backend an ``exec.plan.ParallelPolicy`` names: ``"local"`` →
    ``LocalDist``; ``"shard_map"`` → ``ProcessGroupDist`` on
    ``policy.mesh``, the process group (None: the default group);
    ``"gspmd"`` → ``WholeModelDist`` on it. PyTorch has no GSPMD: the
    whole-model backend inserts the collectives GSPMD would."""
    if policy.backend == "local":
        return LocalDist()
    if policy.backend == "shard_map":
        return ProcessGroupDist(policy.mesh)
    if policy.backend == "gspmd":
        return WholeModelDist(policy.mesh)
    raise ValueError(f"unknown dist backend {policy.backend!r}")


# ---------------------------------------------------------------------------
# Process groups and their processes
# ---------------------------------------------------------------------------

def form_group(rank: int, world_size: int, init_file: str, *,
               backend: str = "gloo", device: str = "cpu",
               timeout_s: float = 300.0) -> torch.device:
    """Join the default process group through the file store at
    ``init_file`` (no fixed port) and return this rank's device:
    ``device="cuda"`` gives rank r the card r % device_count and raises
    where there is none; ``"cpu"`` the CPU. ``timeout_s`` bounds every
    collective, so a hung one fails the rank."""
    if device == "cuda" or backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device "
                               "(torch.cuda.is_available() is false)")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    tdist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_main(fn, rank, world_size, init_file, args, results, threads):
    torch.set_num_threads(threads)
    try:
        # Pickled here with the plain pickler: tensors travel as bytes, not
        # as shared memory that would vanish when this process exits.
        out = pickle.dumps(fn(rank, world_size, init_file, *args),
                           protocol=pickle.HIGHEST_PROTOCOL)
        results.put((rank, True, out))
    except BaseException as err:
        # The rank's boundary: every failure goes to the parent, which
        # fails the run; an interrupt or exit then goes on.
        results.put((rank, False, traceback.format_exc()))
        if not isinstance(err, Exception):
            raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, timeout_s: float = 300.0,
              threads: int = 1) -> list:
    """Run ``fn(rank, world_size, init_file, *args)`` in ``world_size``
    processes (the ``spawn`` context, ``threads`` CPU threads each) and
    return their results in rank order. ``init_file`` is a fresh file-store
    path for ``form_group``. A rank that raises, dies or is still running
    after ``timeout_s`` makes this raise RuntimeError with its traceback,
    once every process has been stopped."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out: dict[int, Any] = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init_file, args,
                                   results, threads), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        # Host orchestration of rank processes, not model code:
        # repro-lint: disable=R003
        deadline = time.monotonic() + timeout_s
        error = None
        try:
            while len(out) < world_size and error is None:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode}")
                    # Host orchestration, not model code:
                    # repro-lint: disable=R003
                    elif time.monotonic() > deadline:
                        error = (f"ranks {sorted(set(range(world_size)) - set(out))}"
                                 f" still running after {timeout_s:.0f} s")
                    continue
                if ok:
                    out[rank] = pickle.loads(val)
                else:
                    error = f"rank {rank} failed:\n{val}"
        finally:
            for p in procs:
                p.join(timeout=5.0 if error is None else 0.1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if error is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}): "
                           f"{error}")
    return [out[r] for r in range(world_size)]
