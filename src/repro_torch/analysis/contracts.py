"""Run contracts: declarative invariants over the record of one eager run.

A contract is a small frozen object whose ``check(artifact)`` returns the
``Violation``s it finds in a ``RunArtifact``, the plain-data record of one
cell's run on every rank of a process group: the result shape of each
all-gather the run executed (``core.dist.collective_shapes()``), its
collectives by kind and pass (``core.dist.collectives()``) and per block
(``roofline.analysis.count_collective_ops``), and its peak memory above what
was allocated before it. The counterpart of the reference's
``CompiledArtifact``, which held XLA's HLO text, ``memory_analysis()`` peak
and static collective counts: eager PyTorch compiles no program, so each term
is read from the run itself. This module imports neither torch nor anything
of the port, so the contracts evaluate against crafted records in tests and
the runner can parse its arguments before any backend starts.

The contracts (full rationale in ``repro_torch/analysis/__init__``):

  NoMergedAllGather      no all-gather result whose leading dim is a merged
                         (B*G)/(B*I) extent — the flatten-forced-gather
                         regression.
  CollectiveBudget       collectives per block within [min, max].
  PeakBytesWithin        the measured peak over AutoChunk's model within
                         [lo, hi].
  CollectiveBytesWithin  each block's forward collectives, calls and bytes,
                         equal to ``core.dap.block_collective_bytes``.

``assert_no_merged_allgather`` is the shared test-side entry point: the
tests and the contract matrix call the same finder, so they cannot drift
apart.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Finders over recorded shapes
# ---------------------------------------------------------------------------


def find_merged_allgathers(gathers, merged_leads, min_rank: int = 3):
    """All-gather result shapes whose leading dim is one of
    ``merged_leads`` (with rank >= min_rank): the signature of a flatten
    that merged a sharded (batch, group) pair, so that the whole merged
    representation had to be gathered. Returns the offending dim lists."""
    leads = set(merged_leads)
    return [list(dims) for dims in gathers
            if len(dims) >= min_rank and dims[0] in leads]


def assert_no_merged_allgather(gathers, merged_leads,
                               min_rank: int = 3) -> None:
    """Shared test-side assertion (the tests and the contract matrix both
    call this one finder)."""
    bad = find_merged_allgathers(gathers, merged_leads, min_rank)
    assert not bad, (
        f"merged-dim all-gather(s) producing lead dims {sorted(merged_leads)} "
        f"(rank >= {min_rank}): {bad}")


# ---------------------------------------------------------------------------
# Artifact + contracts
# ---------------------------------------------------------------------------


@dataclass
class RunArtifact:
    """Plain-data record of one cell's run.

    ``gathers``: the result shape of each all-gather, in order.
    ``peak_bytes``: the largest peak over the ranks, above what each held
    before the cell (None when none was measured). ``collective_counts``:
    collectives per block by the reference's names ({"all-gather": n,
    ...}). ``log``: ``core.dist.collectives()`` of the run, {kind: {pass:
    {"calls", "bytes"}}}."""

    name: str
    gathers: list = field(default_factory=list)
    peak_bytes: int | None = None
    collective_counts: dict = field(default_factory=dict)
    log: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Violation:
    contract: str
    artifact: str
    message: str

    def render(self) -> str:
        return f"{self.artifact}: {self.contract}: {self.message}"


@dataclass(frozen=True)
class NoMergedAllGather:
    """No all-gather may produce a merged-lead tensor (see
    ``find_merged_allgathers``)."""

    merged_leads: frozenset
    min_rank: int = 3
    name: str = field(default="NoMergedAllGather", init=False)

    def check(self, art: RunArtifact) -> list[Violation]:
        bad = find_merged_allgathers(art.gathers, self.merged_leads,
                                     self.min_rank)
        return [Violation(self.name, art.name,
                          f"all-gather produces merged-lead shape {dims} "
                          f"(leads {sorted(self.merged_leads)}, "
                          f"rank >= {self.min_rank})")
                for dims in bad]


@dataclass(frozen=True)
class CollectiveBudget:
    """Collectives per block (``artifact.collective_counts``, already
    divided by the cell's blocks), summed, within [min_per_block,
    max_per_block]: above, the program runs more collectives than it
    should; below, a pass that should run them did not (a backward that
    did nothing, a stack that ran unsharded)."""

    min_per_block: int
    max_per_block: int
    name: str = field(default="CollectiveBudget", init=False)

    def check(self, art: RunArtifact) -> list[Violation]:
        total = sum(art.collective_counts.values())
        if self.min_per_block <= total <= self.max_per_block:
            return []
        return [Violation(self.name, art.name,
                          f"{total:g} collective ops a block outside "
                          f"[{self.min_per_block}, {self.max_per_block}]: "
                          f"{art.collective_counts}")]


@dataclass(frozen=True)
class PeakBytesWithin:
    """The measured peak over the AutoChunk model, peak / modeled, within
    [lo, hi]: above hi the model is lying low (admission control would
    over-admit); below lo the model cries wolf (plans would over-serialize)
    or the run skipped work it should hold memory for (a backward that did
    nothing). The limits are per cell (``cells.PEAK_LIMITS``), set around
    the measured ratios."""

    modeled_bytes: int
    lo: float
    hi: float
    name: str = field(default="PeakBytesWithin", init=False)

    def check(self, art: RunArtifact) -> list[Violation]:
        if art.peak_bytes is None:
            return [Violation(self.name, art.name, "the run measured no peak")]
        ratio = art.peak_bytes / max(self.modeled_bytes, 1)
        if self.lo <= ratio <= self.hi:
            return []
        return [Violation(
            self.name, art.name,
            f"measured peak {art.peak_bytes} over modeled "
            f"{self.modeled_bytes}: ratio {ratio:.3f} outside "
            f"[{self.lo}, {self.hi}]")]


@dataclass(frozen=True)
class CollectiveBytesWithin:
    """Each block's forward collectives are the modeled ones, call for call
    and byte for byte: ``modeled`` is {kind: {"calls", "bytes"}} a block
    (``core.dap.block_collective_bytes``), and the run's log in the forward
    pass holds ``blocks`` times each and no other kind. A collective the
    port's code adds (a gather of a whole tensor re-sliced, say) shows up
    as calls and bytes beyond the model."""

    modeled: dict
    blocks: int = 1
    name: str = field(default="CollectiveBytesWithin", init=False)

    def check(self, art: RunArtifact) -> list[Violation]:
        out = []
        kinds = set(self.modeled) | {k for k, ps in art.log.items()
                                     if "forward" in ps}
        for kind in sorted(kinds):
            want = self.modeled.get(kind, {"calls": 0, "bytes": 0})
            got = art.log.get(kind, {}).get("forward",
                                            {"calls": 0, "bytes": 0})
            for key in ("calls", "bytes"):
                if got[key] != want[key] * self.blocks:
                    out.append(Violation(
                        self.name, art.name,
                        f"{kind} forward {key} {got[key]} over "
                        f"{self.blocks} block(s) != modeled {want[key]} a "
                        "block"))
        return out


def check_all(contracts, art: RunArtifact) -> list[Violation]:
    out: list[Violation] = []
    for c in contracts:
        out.extend(c.check(art))
    return out
