"""repro-lint: the AST half of the analysis gate (rule catalog in
``repro_torch/analysis/__init__``), the port's counterpart of the
reference's ``analysis/lint.py``.

Each rule has a stable ID (R001..R006) so suppressions and CI output survive
renames. Rules are *scoped by module path* (relative to ``src/repro_torch``,
with "/" separators): an env read is a violation anywhere except the one
compat module, a bare ``except Exception:`` anywhere except the resilience
package, a wall-clock read or a draw from a global generator only inside the
model's modules, a raw ``torch.einsum`` only in the Evoformer/pair-stack
modules that must route hot paths through ``kernels/ops.py``.

Calls are resolved to a dotted name through the module's imports:
``import torch.nn.functional as F`` makes ``F.softmax`` read as
``torch.nn.functional.softmax``, ``from time import perf_counter`` makes
``perf_counter()`` read as ``time.perf_counter``. A method call on a tensor
(``x.softmax(-1)``, ``x.normal_()``) is matched by its name.

Suppression syntax (checked on the flagged line and the line directly above,
so it works for both trailing comments and comment-above style)::

    o = torch.einsum("bikc,bjkc->bijc", a, b_full)  # repro-lint: disable=R004

    # repro-lint: disable=R004 -- sanctioned materialized A/B fallback
    o = torch.einsum(...)

A whole-file opt-out (``# repro-lint: disable-file=R003``) exists for
modules whose *job* is the suppressed behavior; prefer per-line
suppressions — they document exactly which statement is sanctioned and why.

This module imports neither torch nor anything of the port: the lint leg of
``python -m repro_torch.analysis`` runs before any backend starts, and test
fixtures lint source strings directly via ``lint_source``.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Rule catalog
# ---------------------------------------------------------------------------

#: Module allowed to read/write the process environment (R001).
ENVCOMPAT_MODULE = "exec/envcompat.py"

#: Package allowed to catch bare ``Exception`` (R002): fault injection has to
#: interpose on arbitrary failures before re-dispatching them typed.
RESILIENCE_PREFIX = "resilience/"

#: The model's modules (R003): their code runs on the card's stream, may be
#: captured into a CUDA graph, and runs again in a checkpoint's recompute.
TRACED_PREFIXES = ("core/", "kernels/", "layers/", "models/", "memory/",
                   "optim/", "train/")

#: Evoformer / pair-stack modules whose hot paths must route through
#: ``kernels/ops.py`` (R004/R005). Sanctioned materialized A/B fallbacks
#: carry per-line suppressions with a rationale.
PAIR_STACK_MODULES = ("core/evoformer.py", "core/alphafold.py")

#: Scopes allowed to write to stdout/stderr directly (R006): the telemetry
#: package itself, the analysis/report tooling, CLI launcher entrypoints,
#: and any ``__main__`` module. Library code routes telemetry through the
#: obs event sink instead.
PRINT_EXEMPT_PREFIXES = ("obs/", "analysis/", "launch/")

#: torch functions that draw from a generator: without ``generator=`` they
#: draw from the process's global one (R003). The ``_like`` forms and
#: dropout take no generator, so they always do.
TORCH_DRAWS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.dropout", "torch.nn.functional.dropout",
})
#: Tensor methods that fill in place from a generator (R003).
TENSOR_DRAWS = frozenset({"uniform_", "normal_", "bernoulli_"})


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    rationale: str


RULES: dict[str, Rule] = {r.id: r for r in (
    Rule("R001", "env access outside exec/envcompat.py",
         "Every process-global toggle must map onto an ExecutionPlan field "
         "(or a named accessor) through the single compat module; a stray "
         "os.environ/os.getenv read (including aliased `from os import "
         "environ`) reintroduces import-order-dependent flags the plan "
         "system was built to kill."),
    Rule("R002", "bare `except Exception:` outside repro_torch/resilience/",
         "Failure handling must dispatch on the typed fault hierarchy "
         "(resilience/errors.py); an anonymous catch-all can swallow "
         "injected faults and admission/deadline errors the serving "
         "engine's retry/degradation routing depends on seeing."),
    Rule("R003", "wall-clock read or global-generator draw in model code",
         "A wall-clock read in the model's modules times the host's "
         "asynchronous launch, not the card's work, and is baked in as a "
         "constant under CUDA-graph capture; timing goes through "
         "timing.py's CUDA events, on the caller's side of the step. "
         "Stdlib random, np.random and draws from torch's global generator "
         "(torch.rand/randn/randint/randperm/normal/bernoulli/multinomial, "
         "Tensor.uniform_/normal_/bernoulli_ and F.dropout without "
         "generator=) make a run depend on every draw before it and differ "
         "between a block and its checkpoint's recompute; the port draws "
         "from explicit torch.Generators."),
    Rule("R004", "raw torch.einsum in an Evoformer/pair-stack module",
         "Pair-stack contractions are the r^2-scale hot paths; they must "
         "route through kernels/ops.py (fused_attention / "
         "fused_triangle_mult / fused_outer_product_mean) so kernel-leg "
         "selection, AutoChunk tiling and the DAP hooks apply. The "
         "sanctioned materialized A/B fallbacks carry per-line "
         "suppressions."),
    Rule("R005", "materialized softmax in an Evoformer/pair-stack module",
         "torch.softmax / F.softmax / Tensor.softmax materialize the "
         "(..., r, r) probabilities in a separate pass over scores summed "
         "beforehand; attention must go through ops.fused_attention "
         "(online softmax) or ops.fused_softmax (scale, bias and mask in "
         "one pass)."),
    Rule("R006", "print()/ad-hoc stdout in a library module",
         "Library code under src/repro_torch/ must not write to "
         "stdout/stderr directly — telemetry goes through the "
         "repro_torch.obs event sink (structured, scoped, schema-validated) "
         "so long-running loops stay quiet and machine-readable. Exempt: "
         "obs/, analysis/, launch/ CLI entrypoints, and __main__ modules."),
)}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str        # path relative to the linted root, "/"-separated
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9,\s]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*repro-lint:\s*disable-file=([A-Z0-9,\s]+)")


def _suppressed_rules(line_text: str) -> set[str]:
    m = _SUPPRESS_RE.search(line_text)
    if not m:
        return set()
    return {t.strip() for t in m.group(1).split(",") if t.strip()}


def _file_suppressions(src: str) -> set[str]:
    out: set[str] = set()
    for m in _SUPPRESS_FILE_RE.finditer(src):
        out |= {t.strip() for t in m.group(1).split(",") if t.strip()}
    return out


# ---------------------------------------------------------------------------
# The visitor
# ---------------------------------------------------------------------------

_DATETIME_NOW = {"now", "utcnow", "today"}
_ENV_ACCESSORS = ("environ", "environb", "getenv", "putenv", "unsetenv")


class _Visitor(ast.NodeVisitor):
    # Modules whose names are resolved; `from M import x` for M among them
    # binds x to "M.x".
    _TRACKED = {"os", "sys", "time", "random", "datetime", "numpy", "jax",
                "jax.numpy", "numpy.random", "torch", "torch.nn",
                "torch.nn.functional"}

    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: list[tuple[str, int, int, str]] = []
        # local name -> dotted name, for the tracked modules and their names
        self.names: dict[str, str] = {}

        self.in_traced = relpath.startswith(TRACED_PREFIXES)
        self.in_pair_stack = relpath in PAIR_STACK_MODULES
        self.env_exempt = relpath == ENVCOMPAT_MODULE
        self.exception_exempt = relpath.startswith(RESILIENCE_PREFIX)
        self.print_exempt = (relpath.startswith(PRINT_EXEMPT_PREFIXES)
                             or relpath.endswith("__main__.py"))

    # -- helpers ----------------------------------------------------------

    def _flag(self, rule: str, node: ast.AST, message: str):
        self.findings.append(
            (rule, node.lineno, getattr(node, "end_lineno", node.lineno),
             message))

    def _dotted(self, node: ast.AST) -> str | None:
        """The dotted name of an attribute chain whose root is a tracked
        module or a name imported from one (`F.softmax` ->
        'torch.nn.functional.softmax'), else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name) or node.id not in self.names:
            return None
        return ".".join([self.names[node.id], *reversed(parts)])

    # -- imports ----------------------------------------------------------

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            if a.name in self._TRACKED:
                if a.asname:
                    self.names[a.asname] = a.name
                else:                   # `import torch.nn` binds `torch`
                    root = a.name.split(".")[0]
                    self.names[root] = root
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module == "os" and not self.env_exempt:
            for a in node.names:
                if a.name in _ENV_ACCESSORS:
                    self._flag("R001", node,
                               f"`from os import {a.name}` aliases the "
                               "process environment outside "
                               f"{ENVCOMPAT_MODULE}")
        if node.module in self._TRACKED:
            for a in node.names:
                self.names[a.asname or a.name] = f"{node.module}.{a.name}"
        self.generic_visit(node)

    # -- R001: environment access -----------------------------------------

    def visit_Attribute(self, node: ast.Attribute):
        name = self._dotted(node)
        if (not self.env_exempt and name is not None
                and name.split(".")[:2] in (["os", "environ"],
                                            ["os", "environb"])):
            self._flag("R001", node,
                       f"{'.'.join(name.split('.')[:2])} access outside "
                       f"{ENVCOMPAT_MODULE}")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        # `from os import environ` then `environ[...]`/`environ.get(...)`
        name = self.names.get(node.id)
        if (not self.env_exempt and name is not None
                and name in ("os.environ", "os.environb")):
            self._flag("R001", node,
                       f"aliased {name} access outside {ENVCOMPAT_MODULE}")

    # -- R002: bare except Exception --------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if not self.exception_exempt and node.name is None:
            t = node.type
            if t is None:
                self._flag("R002", node,
                           "bare `except:` swallows typed failures")
            elif (isinstance(t, ast.Name)
                  and t.id in ("Exception", "BaseException")):
                self._flag("R002", node,
                           f"bare `except {t.id}:` outside "
                           f"{RESILIENCE_PREFIX} — catch (or re-raise) the "
                           "typed hierarchy, or bind it (`as err`) and "
                           "re-dispatch")
        self.generic_visit(node)

    # -- calls: R001 (os.getenv), R003, R004, R005, R006 ------------------

    def visit_Call(self, node: ast.Call):
        func = node.func
        name = self._dotted(func)

        # R001: os.getenv()/os.putenv()/os.unsetenv(), aliased or not
        if (not self.env_exempt and name in ("os.getenv", "os.putenv",
                                             "os.unsetenv")):
            self._flag("R001", node, f"{name}() outside {ENVCOMPAT_MODULE}")

        # R006: ad-hoc stdout in library modules — telemetry goes through
        # the obs event sink, not print()/sys.stdout.write.
        if not self.print_exempt:
            if isinstance(func, ast.Name) and func.id == "print":
                self._flag("R006", node,
                           "print() in a library module — emit through the "
                           "repro_torch.obs event sink (or move output to a "
                           "__main__/launch entrypoint)")
            elif name is not None and name.split(".")[:2] in (
                    ["sys", "stdout"], ["sys", "stderr"]) and name.split(
                    ".")[-1] in ("write", "writelines"):
                self._flag("R006", node,
                           f"{name}() in a library module — emit through "
                           "the repro_torch.obs event sink")

        if self.in_traced:
            self._check_traced_call(node, name)
        if self.in_pair_stack:
            self._check_pair_stack_call(node, name)
        self.generic_visit(node)

    def _check_traced_call(self, node: ast.Call, name: str | None):
        mod = name.split(".")[0] if name else None
        if mod == "time":
            self._flag("R003", node,
                       f"{name}() in model code (times the host's launch, "
                       "not the card; a constant under CUDA-graph capture) "
                       "— time with timing.py's CUDA events")
        elif mod == "random":
            self._flag("R003", node,
                       f"{name}() in model code — draw from an explicit "
                       "torch.Generator")
        elif name is not None and name.startswith("numpy.random"):
            self._flag("R003", node,
                       f"{name}() in model code — draw from an explicit "
                       "torch.Generator")
        elif mod == "datetime" and name.split(".")[-1] in _DATETIME_NOW:
            self._flag("R003", node, f"{name}() in model code")
        elif not any(k.arg == "generator" for k in node.keywords):
            if name in TORCH_DRAWS:
                self._flag("R003", node,
                           f"{name}() without generator= draws from the "
                           "global generator — pass an explicit "
                           "torch.Generator")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in TENSOR_DRAWS):
                self._flag("R003", node,
                           f".{node.func.attr}() without generator= draws "
                           "from the global generator — pass an explicit "
                           "torch.Generator")

    def _check_pair_stack_call(self, node: ast.Call, name: str | None):
        # R004: raw einsum (torch.einsum / np.einsum / jnp.einsum)
        if name is not None and name.split(".")[-1] == "einsum":
            self._flag("R004", node,
                       f"raw {name} in a pair-stack module — route through "
                       "kernels/ops.py (or suppress a sanctioned "
                       "materialized A/B fallback)")
        # R005: materialized softmax: torch.softmax, F.softmax, x.softmax
        if ((isinstance(node.func, ast.Attribute)
             and node.func.attr == "softmax")
                or (name is not None and name.split(".")[-1] == "softmax")):
            self._flag("R005", node,
                       "materialized softmax in a pair-stack module — use "
                       "ops.fused_attention / ops.fused_softmax")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lint_source(src: str, relpath: str) -> list[Finding]:
    """Lint one module's source. ``relpath`` is the path relative to the
    ``src/repro_torch`` root ("/"-separated) — it decides which rules
    apply."""
    try:
        tree = ast.parse(src)
    except SyntaxError as err:
        return [Finding("R000", relpath, err.lineno or 0,
                        f"syntax error: {err.msg}")]
    v = _Visitor(relpath)
    v.visit(tree)
    if not v.findings:
        return []
    lines = src.splitlines()
    file_off = _file_suppressions(src)

    def suppressed(rule: str, lineno: int, end_lineno: int) -> bool:
        if rule in file_off:
            return True
        # Line above the flagged node, plus every line of the node itself
        # (a trailing comment on any continuation line of a multiline call
        # counts).
        for ln in range(lineno - 1, (end_lineno or lineno) + 1):
            if 1 <= ln <= len(lines) and rule in _suppressed_rules(
                    lines[ln - 1]):
                return True
        return False

    out: list[Finding] = []
    seen: set[tuple[str, int]] = set()  # nested chains (os.environ.get)
    for rule, line, end, msg in sorted(v.findings, key=lambda f: f[1]):
        if (rule, line) in seen or suppressed(rule, line, end):
            continue
        seen.add((rule, line))
        out.append(Finding(rule, relpath, line, msg))
    return out


def lint_tree(root: str | None = None) -> list[Finding]:
    """Lint every .py module under ``root`` (default: the
    ``src/repro_torch`` tree this module lives in)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings: list[Finding] = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                findings.extend(lint_source(fh.read(), rel))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def render_report(findings: list[Finding]) -> str:
    if not findings:
        return "repro-lint: clean"
    by_rule: dict[str, int] = {}
    lines = [f.render() for f in findings]
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{k} x{v}" for k, v in sorted(by_rule.items()))
    lines.append(f"repro-lint: {len(findings)} finding(s) ({summary})")
    return "\n".join(lines)
