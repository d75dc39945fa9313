"""repro_torch.analysis — static analysis of the port's source tree and
contracts over its runs, wired as one gate (`python -m
repro_torch.analysis`): the port's counterpart of the reference's
``repro.analysis``.

The port's hardest-won properties are invariants of *artifacts*: the AST
(where a stray env read or a bare except lives) and what a run does (where a
merged-dim all-gather, an extra collective or a transient kept too long
shows). This package checks both, with stable IDs so a finding means the
same thing in a test, in CI output, and in a suppression comment.

Two passes, one runner:

  lint.py       repro-lint — AST pass over src/repro_torch.
  contracts.py  declarative contracts over a run's record (``RunArtifact``:
                all-gather result shapes, collectives by kind and pass and
                per block, peak memory); imports no torch, so tests feed it
                crafted records.
  cells.py      the (cell, ExecutionPlan preset) matrix the contracts run
                against, every cell on every rank of a gloo group: the
                Evoformer forward and gradient under WholeModelDist (all
                four attention sites + triangle/OPM), the fused triangle/
                OPM ops through the DAP hooks, the reduced 2-block
                AlphaFold training-loss gradient, and the DAP stack.
  __main__.py   `python -m repro_torch.analysis [--presets default,oracle]
                [--ranks 2] [--device cpu|cuda] [--lint-only|
                --contracts-only] [--cells ...] [--out FILE]` — prints
                findings, exits nonzero on any finding or violation, writes
                a JSON record only to ``--out``.

Lint rules (scope in parentheses; full rationale strings in lint.RULES):

  R001  env access outside exec/envcompat.py (everywhere else) — includes
        `from os import environ`, `os.getenv`, and aliased accessors.
        Every process toggle flows through the one env-compat module
        (the kernels' build reads CUDA_HOME there, ``cuda_home()``).
  R002  bare `except Exception:` / `except:` (outside resilience/) —
        failure handling must see the typed fault hierarchy; a named
        `except Exception as err:` with re-dispatch is allowed.
  R003  wall-clock read or global-generator draw in model code (core/,
        kernels/, layers/, models/, memory/, optim/, train/) — a clock
        there times the host's asynchronous launch, not the card's work,
        and is a constant under CUDA-graph capture (time the card through
        timing.py's CUDA events); stdlib random, np.random and torch's
        global generator (torch.rand/randn/randint/randperm/normal/
        bernoulli/multinomial, Tensor.uniform_/normal_/bernoulli_, and
        F.dropout, without generator=) make a run depend on every draw
        before it and a checkpoint's recompute draw anew; the port draws
        from explicit torch.Generators.
  R004  raw torch.einsum / np.einsum in an Evoformer/pair-stack module
        (core/evoformer.py, core/alphafold.py) — the r²-scale
        contractions route through kernels/ops.py so kernel legs,
        AutoChunk tiling and the DAP hooks apply. Sanctioned materialized
        A/B fallbacks carry per-line suppressions with a rationale.
  R005  materialized softmax in an Evoformer/pair-stack module (same
        scope) — torch.softmax, F.softmax, torch.nn.functional.softmax and
        Tensor.softmax materialize the (..., r, r) probabilities over
        scores summed beforehand; use ops.fused_attention /
        ops.fused_softmax.
  R006  print()/sys.stdout.write in a library module (everywhere except
        obs/, analysis/, launch/, and __main__ entrypoints) — telemetry
        from library code goes through the repro_torch.obs event sink.

Suppression syntax (trailing on the flagged line, or on the line above):

    o = torch.einsum(...)  # repro-lint: disable=R004
    # repro-lint: disable=R004,R005 -- rationale here
    # repro-lint: disable-file=R003        (whole-file opt-out; prefer lines)

Contracts (evaluated per matrix cell; rationale in contracts.py), each the
counterpart of the reference's over compiled XLA:

  NoMergedAllGather(leads, min_rank)  no all-gather result with a merged
      (B*G)/(B*I) leading dim, over the shapes ``core.dist`` records for
      each all-gather it runs (the reference read HLO text).
      `assert_no_merged_allgather` is the same finder the tests call.
  CollectiveBudget(min_per_block, max_per_block)  collectives per block
      within [min, max], over ``roofline.analysis.count_collective_ops(
      collectives(), blocks)``: an eager run counts every executed call,
      so the cell's blocks divide it (the reference counted a traced scan
      body once). The floor catches a pass that ran none of its
      collectives (a backward that did nothing, a stack run unsharded).
  PeakBytesWithin(modeled, lo, hi)  the run's peak over AutoChunk's model
      within calibrated [lo, hi], both directions: on the CPU the peak
      live bytes ``counting(memory=True)`` records, on the card the
      allocator's ``max_memory_allocated`` above what was held before (the
      reference read ``memory_analysis()``).
  CollectiveBytesWithin(modeled, blocks)  each block's forward collectives
      equal to ``core.dap.block_collective_bytes``, call for call and byte
      for byte: a gather-then-reslice in the port's code shows as extra
      bytes. It takes the place of the reference's NoInvoluntaryRemat
      (``find_gather_then_slice``), which is dropped: eager PyTorch has no
      partitioner that reshards, so a collective runs only where the
      port's own code calls one.

The reference's ``dap_jaxpr`` cell folds into ``dap_stack``: eager has one
view of its collectives, not an HLO view and a jaxpr view.

Adding a contract for a new kernel or module: write a cell in cells.py that
runs it the way production does (under `use_plan(preset(...))` on the
group), give it a `PeakBytesWithin` against its AutoChunk model term and a
`NoMergedAllGather` with the shapes a flatten would produce, add its name to
PEAK_LIMITS/COLLECTIVE_BUDGETS, and calibrate on the ratios and counts
`python -m repro_torch.analysis` prints on the CPU and on the card.

lint.py and contracts.py import no torch; cells.py does, and the runner
imports it only for the contract pass.
"""
from repro_torch.analysis.contracts import (  # noqa: F401
    CollectiveBudget,
    CollectiveBytesWithin,
    NoMergedAllGather,
    PeakBytesWithin,
    RunArtifact,
    Violation,
    assert_no_merged_allgather,
    check_all,
    find_merged_allgathers,
)
from repro_torch.analysis.lint import (  # noqa: F401
    Finding,
    RULES,
    lint_source,
    lint_tree,
    render_report,
)
