"""simlint — AST rules that keep the sim path bit-deterministic.

The whole reproduction hangs on one property: a discrete-event run is a
pure function of its seed.  The determinism digest
(``ReplayResult.digest``) can tell you *that* two runs diverged, never
*where*; these rules flag the constructs that historically cause such
divergence — wall-clock reads, unseeded RNG, set-iteration order,
``id()`` tie-breaks, leaked resource slots, swallowed ``GeneratorExit``,
dict-order float reductions, and out-of-band mutation of engine-owned
accounting — at the line that introduces them.

Scope: only *sim-path* packages under ``src/repro_torch`` are linted
(``net/``, ``storage/``, ``core/``, ``scenarios/``).  Host-path code
(``launch/``, ``kernels/``, ``serve/`` …) legitimately reads wall-clock
and machine RNG; it is excluded by path, not by pragma.  The rules and the
pragma syntax are the JAX package's (``docs/simlint.md``).

Suppression, two tiers:

* a pragma on (or one line above) the offending line::

      t0 = time.perf_counter()  # simlint: ok SIM001 wall telemetry only

  The reason is mandatory — a bare ``# simlint: ok SIM001`` still
  reports (with a "pragma missing reason" note).
* the committed baseline (``simlint.baseline`` next to this file) for
  grandfathered benign hits, keyed by ``path:rule:scope`` (no line
  numbers, so unrelated edits don't churn it).  ``--check`` fails on
  *new* findings AND on *stale* baseline entries, so the baseline can
  only shrink.

Implementation is stdlib-only (``ast`` + ``tokenize``): no new deps.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import tokenize
from collections import Counter

#: packages under src/repro_torch that run inside (or feed) the event loop.
SIM_SCOPE_PACKAGES = ("net", "storage", "core", "scenarios")

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BASELINE_PATH = pathlib.Path(__file__).with_name("simlint.baseline")

RULES = {
    "SIM001": "wall-clock read in sim-path code",
    "SIM002": "module-level / unseeded RNG instead of a threaded Generator",
    "SIM003": "iteration over an unordered set feeding downstream order",
    "SIM004": "id()/hash() identity used where a stable key is needed",
    "SIM005": "Acquire without a try/finally-guarded Release in a task",
    "SIM006": "bare/broad except that can swallow GeneratorExit in a task",
    "SIM007": "dict-order-dependent reduction over .values()/.items()",
    "SIM008": "engine-owned resource/link accounting mutated off-loop",
}

_PRAGMA_RE = re.compile(
    r"#\s*simlint:\s*ok\s+(?P<rules>SIM\d{3}(?:\s*,\s*SIM\d{3})*)(?P<reason>.*)"
)

_WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns",
}
_DATETIME_TAILS = {"now", "utcnow", "today"}

_RANDOM_MODULE_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "expovariate",
    "betavariate", "seed", "getrandbits", "triangular", "vonmisesvariate",
}
_NP_LEGACY_FNS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "poisson", "exponential", "binomial", "seed",
    "bytes", "geometric", "gamma", "beta",
}

_SET_METHODS = {"union", "intersection", "difference", "symmetric_difference"}
#: call wrappers whose argument order is *observable* downstream — feeding
#: one of these a set leaks hash order into scheduling / results.
_ORDER_SINK_CALLS = {"list", "tuple", "iter", "enumerate", "sum", "reversed"}

#: Resource/link telemetry the event loop owns; writes anywhere else are
#: almost certainly bypassing Acquire/Release (or Backbone.transfer).
_RESOURCE_ATTRS = {
    "in_use", "in_use_by_class", "acquired", "acquired_by_class",
    "wait_ms_total", "wait_ms_by_class", "max_queue",
}
_LINK_ATTRS = {"link_bytes", "nic_bytes"}
_RESOURCE_OWNER = "events.py"
_LINK_OWNER = "backbone.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit, printable and baseline-addressable."""

    path: str  # repo-relative posix path
    line: int
    col: int
    rule: str
    message: str
    scope: str  # enclosing function qualname, or "<module>"

    @property
    def baseline_key(self) -> str:
        return f"{self.path}:{self.rule}:{self.scope}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message} [in {self.scope}]")


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _contains_yield(node: ast.AST) -> bool:
    """True iff ``node`` yields in *this* function (nested defs excluded)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, (ast.Yield, ast.YieldFrom)):
            return True
        if _contains_yield(child):
            return True
    return False


def _handler_types(handler: ast.ExceptHandler) -> list[str]:
    t = handler.type
    if t is None:
        return ["<bare>"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return [d for d in (_dotted(e) for e in elts) if d is not None]


def _has_bare_raise(node: ast.AST) -> bool:
    for child in ast.walk(node):
        if isinstance(child, ast.Raise) and child.exc is None:
            return True
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, filename: str):
        self.path = path
        self.filename = filename
        self.findings: list[Finding] = []
        self.scope_stack: list[str] = []
        # per-function: is it a generator (sim task)?
        self.genfunc_stack: list[bool] = []
        # alias -> canonical module name ("import numpy as np")
        self.module_aliases: dict[str, str] = {}
        # bare name -> canonical dotted origin ("from time import time")
        self.from_imports: dict[str, str] = {}
        # nodes inside a `finally:` block (SIM005)
        self.finally_depth = 0

    # -- bookkeeping -----------------------------------------------------------
    @property
    def scope(self) -> str:
        return ".".join(self.scope_stack) or "<module>"

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(
            path=self.path, line=node.lineno, col=node.col_offset,
            rule=rule, message=message, scope=self.scope,
        ))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.module_aliases[alias.asname or alias.name.split(".")[0]] = \
                alias.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for alias in node.names:
                self.from_imports[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
        self.generic_visit(node)

    def _resolve(self, dotted: str | None) -> str | None:
        """Map through import aliases: 'np.random.rand' -> 'numpy.random.rand'."""
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head in self.from_imports:
            origin = self.from_imports[head]
            return f"{origin}.{rest}" if rest else origin
        if head in self.module_aliases:
            mod = self.module_aliases[head]
            return f"{mod}.{rest}" if rest else mod
        return dotted

    # -- function scopes (SIM005 / SIM006 need generator-ness) -----------------
    def _visit_func(self, node) -> None:
        self.scope_stack.append(node.name)
        self.genfunc_stack.append(_contains_yield(node))
        self._check_sim005(node)
        self.generic_visit(node)
        self.genfunc_stack.pop()
        self.scope_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope_stack.append(node.name)
        self.generic_visit(node)
        self.scope_stack.pop()

    # -- SIM001 / SIM002 / SIM003(sinks) / SIM004 / SIM007 ---------------------
    def visit_Call(self, node: ast.Call) -> None:
        raw = _dotted(node.func)
        resolved = self._resolve(raw)

        if resolved is not None:
            self._check_sim001(node, resolved)
            self._check_sim002(node, resolved)

        if isinstance(node.func, ast.Name):
            if node.func.id == "id" and node.args:
                self._emit(node, "SIM004",
                           "id() is a memory address — not stable across runs; "
                           "order by an explicit (priority, seq) key instead")
            elif node.func.id == "hash" and node.args:
                self._emit(node, "SIM004",
                           "hash() of str/bytes depends on PYTHONHASHSEED; "
                           "use a stable key (sorted tuple, explicit id) instead")
            elif node.func.id in _ORDER_SINK_CALLS and node.args:
                if self._is_unordered(node.args[0]):
                    self._emit(node, "SIM003",
                               f"{node.func.id}() over a set leaks hash order "
                               "downstream; wrap in sorted(...) first")
        if (isinstance(node.func, ast.Attribute) and node.func.attr == "join"
                and node.args and self._is_unordered(node.args[0])):
            self._emit(node, "SIM003",
                       "str.join over a set leaks hash order; sort first")

        self._check_sim007(node, resolved)
        self.generic_visit(node)

    def _check_sim001(self, node: ast.Call, resolved: str) -> None:
        hit = resolved in _WALL_CLOCK_CALLS
        if not hit and resolved.startswith("datetime."):
            hit = resolved.rsplit(".", 1)[-1] in _DATETIME_TAILS
        if hit:
            self._emit(node, "SIM001",
                       f"{resolved}() reads the wall clock — sim code must "
                       "derive time from loop.now (or gate telemetry behind "
                       "a pragma)")

    def _check_sim002(self, node: ast.Call, resolved: str) -> None:
        parts = resolved.split(".")
        if parts[0] == "random" and len(parts) == 2 and parts[1] in _RANDOM_MODULE_FNS:
            self._emit(node, "SIM002",
                       f"{resolved}() uses the process-global RNG; thread a "
                       "seeded np.random.Generator (or random.Random(seed)) "
                       "through instead")
        elif (len(parts) >= 3 and parts[-3] in ("numpy", "np")
                and parts[-2] == "random" and parts[-1] in _NP_LEGACY_FNS):
            self._emit(node, "SIM002",
                       f"{resolved}() hits numpy's legacy global RNG; use a "
                       "seeded default_rng(seed) Generator")
        elif parts[-1] == "default_rng" and "random" in parts and not node.args:
            self._emit(node, "SIM002",
                       "default_rng() without a seed draws OS entropy; pass "
                       "an explicit seed derived from the run seed")

    def _is_unordered(self, expr: ast.AST) -> bool:
        """Expressions whose iteration order is hash-dependent."""
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func)
            if d in ("set", "frozenset"):
                return True
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in _SET_METHODS):
                return True
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            # a | b, a - b … where either side is visibly a set
            return self._is_unordered(expr.left) or self._is_unordered(expr.right)
        return False

    def visit_For(self, node: ast.For) -> None:
        if self._is_unordered(node.iter):
            self._emit(node, "SIM003",
                       "iterating a set: order follows hash seed / insertion "
                       "history, not a stable key — use sorted(...)")
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            if self._is_unordered(gen.iter):
                self._emit(node, "SIM003",
                           "comprehension over a set leaks hash order into "
                           "the result; use sorted(...)")
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    def _check_sim007(self, node: ast.Call, resolved: str | None) -> None:
        if resolved not in ("sum", "math.fsum", "fsum"):
            return
        if not node.args:
            return
        arg = node.args[0]
        if self._is_dict_view(arg):
            self._emit(node, "SIM007",
                       "reduction over dict .values()/.items(): float sums "
                       "are order-sensitive — iterate sorted(d) (or pragma "
                       "if provably integer/commutative)")
        elif isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
            if any(self._is_dict_view(g.iter) for g in arg.generators):
                # len(...) elements are exact ints: order can't matter
                elt = arg.elt
                if isinstance(elt, ast.Call) and _dotted(elt.func) == "len":
                    return
                self._emit(node, "SIM007",
                           "reduction over dict .values()/.items(): float "
                           "sums are order-sensitive — iterate sorted(d) "
                           "(or pragma if provably integer/commutative)")

    @staticmethod
    def _is_dict_view(expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in ("values", "items"))

    # -- SIM005: Acquire without finally-guarded Release -----------------------
    def _check_sim005(self, node) -> None:
        acquires: list[ast.AST] = []
        releases: list[tuple[ast.AST, bool]] = []

        def walk(n: ast.AST, in_finally: bool) -> None:
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, (ast.Yield, ast.YieldFrom)) \
                        and child.value is not None:
                    d = _dotted(getattr(child.value, "func", None)) \
                        if isinstance(child.value, ast.Call) else None
                    if d is not None:
                        tail = d.rsplit(".", 1)[-1]
                        if tail == "Acquire":
                            acquires.append(child)
                        elif tail in ("Release", "safe_release"):
                            # `yield from safe_release(Release(...))` is the
                            # close-safe finally idiom (see events.safe_release)
                            releases.append((child, in_finally))
                if isinstance(child, ast.Try):
                    for part in (child.body, child.handlers, child.orelse):
                        for sub in part:
                            walk(sub, in_finally)
                    for sub in child.finalbody:
                        walk(sub, True)
                else:
                    walk(child, in_finally)

        walk(node, False)
        if not acquires:
            return
        if not releases:
            for acq in acquires:
                self._emit(acq, "SIM005",
                           "task acquires a resource slot but never yields "
                           "Release — a thrown exception leaks the slot; "
                           "wrap the critical section in try/finally")
        elif not any(fin for _, fin in releases):
            for acq in acquires:
                self._emit(acq, "SIM005",
                           "Release is not inside a finally: block — an "
                           "exception between Acquire and Release leaks the "
                           "slot; use try/finally")

    # -- SIM006: except clauses that can swallow GeneratorExit -----------------
    def visit_Try(self, node: ast.Try) -> None:
        in_genfunc = bool(self.genfunc_stack) and self.genfunc_stack[-1]
        body_yields = any(_contains_yield(s) for s in node.body)
        control_flow_reraised = any(
            ("GeneratorExit" in _handler_types(han)
             or "KeyboardInterrupt" in _handler_types(han))
            and _has_bare_raise(han)
            for han in node.handlers
        )
        for han in node.handlers:
            types = _handler_types(han)
            if "<bare>" in types or "BaseException" in types:
                if not _has_bare_raise(han):
                    self._emit(han, "SIM006",
                               "bare/BaseException except swallows "
                               "GeneratorExit and KeyboardInterrupt — catch "
                               "Exception, or re-raise control-flow "
                               "exceptions explicitly")
            elif (in_genfunc and body_yields and "Exception" in types
                  and not control_flow_reraised):
                self._emit(han, "SIM006",
                           "broad `except Exception` around a yielding "
                           "region in a loop task: add `except "
                           "(GeneratorExit, KeyboardInterrupt): raise` above "
                           "it so task teardown/interrupt always propagates")
        self.generic_visit(node)

    # -- SIM008: off-loop mutation of engine-owned accounting ------------------
    def _check_sim008_target(self, target: ast.AST, node: ast.AST) -> None:
        if not isinstance(target, ast.Attribute):
            return
        attr = target.attr
        if attr in _RESOURCE_ATTRS and self.filename != _RESOURCE_OWNER:
            self._emit(node, "SIM008",
                       f"direct write to Resource.{attr} outside the event "
                       "loop engine — go through Acquire/Release effects so "
                       "accounting (and simsan) stays consistent")
        elif attr in _LINK_ATTRS and self.filename not in (
                _LINK_OWNER, _RESOURCE_OWNER):
            self._emit(node, "SIM008",
                       f"direct write to link accounting .{attr} outside the "
                       "backbone — use Backbone.transfer / Transfer effects")

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_sim008_target(target, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_sim008_target(node.target, node)
        self.generic_visit(node)


# -- pragmas ---------------------------------------------------------------------
def _collect_pragmas(source: str) -> dict[int, tuple[set[str], bool]]:
    """line -> (suppressed rules, has_reason)."""
    out: dict[int, tuple[set[str], bool]] = {}
    try:
        tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if m is None:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            has_reason = bool(m.group("reason").strip())
            out[tok.start[0]] = (rules, has_reason)
    except tokenize.TokenError:
        pass
    return out


def _apply_pragmas(findings: list[Finding], source: str) -> list[Finding]:
    pragmas = _collect_pragmas(source)
    kept: list[Finding] = []
    for f in findings:
        hit = pragmas.get(f.line) or pragmas.get(f.line - 1)
        if hit is not None and f.rule in hit[0]:
            if hit[1]:
                continue  # suppressed with a reason
            f = dataclasses.replace(
                f, message=f.message + " (pragma present but missing a "
                                       "reason — add one after the rule code)")
        kept.append(f)
    return kept


# -- entry points ----------------------------------------------------------------
def in_scope(path: pathlib.Path, root: pathlib.Path = REPO_ROOT) -> bool:
    """Sim-path test: src/repro_torch/{net,storage,core,scenarios}/**.py only."""
    try:
        rel = path.resolve().relative_to(root / "src" / "repro_torch")
    except ValueError:
        return False
    return bool(rel.parts) and rel.parts[0] in SIM_SCOPE_PACKAGES


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one file's source; ``path`` is repo-relative (posix)."""
    tree = ast.parse(source, filename=path)
    linter = _Linter(path=path, filename=pathlib.PurePosixPath(path).name)
    linter.visit(tree)
    return _apply_pragmas(linter.findings, source)


def iter_target_files(paths: list[pathlib.Path] | None = None,
                      root: pathlib.Path = REPO_ROOT) -> list[pathlib.Path]:
    if not paths:
        paths = [root / "src" / "repro_torch"]
    out: list[pathlib.Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob("*.py")
                              if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            out.append(p)
    return [f for f in out if in_scope(f, root)]


def lint_paths(paths: list[pathlib.Path] | None = None,
               root: pathlib.Path = REPO_ROOT) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_target_files(paths, root):
        rel = f.resolve().relative_to(root).as_posix()
        findings.extend(lint_source(f.read_text(), rel))
    return findings


# -- baseline --------------------------------------------------------------------
def load_baseline(path: pathlib.Path = BASELINE_PATH) -> Counter:
    """Multiset of grandfathered ``path:rule:scope`` keys (trailing
    ``# reason`` comments and blank lines ignored)."""
    if not path.exists():
        return Counter()
    entries: Counter = Counter()
    for line in path.read_text().splitlines():
        entry = line.split("#", 1)[0].strip()
        if entry:
            entries[entry] += 1
    return entries


def diff_baseline(findings: list[Finding],
                  baseline: Counter) -> tuple[list[Finding], list[str]]:
    """(new findings not in baseline, stale baseline keys with no hit)."""
    remaining = Counter(baseline)
    new: list[Finding] = []
    for f in findings:
        if remaining.get(f.baseline_key, 0) > 0:
            remaining[f.baseline_key] -= 1
        else:
            new.append(f)
    stale = sorted(remaining.elements())
    return new, stale


def write_baseline(findings: list[Finding],
                   path: pathlib.Path = BASELINE_PATH) -> None:
    lines = [
        "# simlint baseline: grandfathered benign findings, one",
        "# path:RULE:scope key per hit.  Regenerate with",
        "#   python -m repro_torch.analysis --write-baseline",
        "# New code should use inline pragmas instead; this file should",
        "# only ever shrink.",
    ]
    lines.extend(sorted(f.baseline_key for f in findings))
    path.write_text("\n".join(lines) + "\n")
