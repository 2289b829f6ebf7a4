"""Trace-safety AST lint: the static half of the port's program-contract
gate (the counterpart of the JAX package's ``contracts/lint.py``).

A stdlib-``ast`` pass (no ``torch`` import: the lint runs anywhere,
instantly) over the port's source, with the JAX gate's ten rule ids:

====================  ==================================================
rule id               contract
====================  ==================================================
``callback-gate``     a host read in a step body — ``.item()``,
                      ``.tolist()``, ``.cpu()``, ``.numpy()``,
                      ``float(t)``/``bool(t)``/``int(t)`` on the loop
                      state or a torch result, ``torch.cuda.synchronize``
                      — must sit behind a static-flag ``if`` or carry a
                      reasoned suppression. A step body is a function a
                      solve driver (``solvers.pcg.drive``,
                      ``solvers.batched.step_members``) calls each step:
                      a local function passed to one, or the function a
                      ``make_*body*``/``make_*step*`` factory returns. The
                      sanctioned sites are the drivers' own ``done``
                      reads (outside any body) and ``obs/stream.py``
                      (the JAX rule's callbacks, ``jax.debug.*`` and
                      ``io_callback``, have these as their eager twins)
``traced-branch``     no Python ``if``/``while`` on the tensor-valued loop
                      state (a body's parameters) inside a step body: in
                      eager PyTorch it is a hidden host sync, the twin of
                      JAX's branch on a traced value (``is None`` tests
                      and ``isinstance``/``hasattr`` are not branches on
                      a value)
``static-default``    no mutable default (list, dict, set literal, or a
                      call other than a frozen policy or ``tuple``/
                      ``frozenset``) on a function in solver code. JAX's
                      second half, hashable ``jax.jit`` static-arg
                      defaults, has no PyTorch counterpart: the port
                      compiles no program keyed on arguments, so that
                      half is exempt (:data:`STATIC_DEFAULT_EXEMPTION`)
``wallclock``         no wall-clock reads (``time.time`` & friends) in
                      solver/ops/mg/integrity/parallel/krylov code
``rng``               no unseeded RNG (``random.*``,
                      ``np.random.<dist>``) there; seeded
                      ``default_rng(<literal>)`` and ``random.Random(seed)``
                      are fine
``counter-doc``       every ``metrics.inc``/``gauge``/``observe`` string
                      literal is documented in the port's
                      ``obs/metrics.py`` docstring
``flight-kind``       flight-recorder span/point kinds passed as string
                      literals are ``SPAN_*``/``POINT_*`` constants of
                      the port's ``obs/flight.py``
``chaos-registry``    every chaos scenario function (one ``seed``
                      parameter) of ``testing/chaos.py`` is registered
                      with ``@scenario``
``fingerprint-key``   geometry fingerprints never reach a bucket-cache
                      or cohort key (families co-batch)
``suppression-reason``  an inline suppression without a reason string is
                      itself a finding
====================  ==================================================

Suppression syntax (a reason is required)::

    some_call()  # contracts: allow=wallclock -- host-side build timing

on the flagged line or the line directly above it. Suppressions are kept
in the report (``suppressed: true`` and the reason).

Run through ``python -m poisson_tpu_torch.contracts`` (with the program
ledger and the drift checks) or call :func:`run_lint`.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import asdict, dataclass
from typing import Iterable, Optional

# ---------------------------------------------------------------------------
# findings and suppressions


@dataclass
class Finding:
    """One diagnostic: rule id, location, message, suppression state."""

    rule: str
    file: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None


_SUPPRESS_RE = re.compile(
    r"#\s*contracts:\s*allow=([A-Za-z0-9_,-]+)"
    r"(?:\s*--\s*(\S.*?))?\s*$"
)


def _parse_suppressions(source: str) -> dict:
    """line number -> (set of rule ids, reason or None). 1-based.

    Tokenized, not regexed over raw lines: the pattern inside a string
    literal or a docstring (e.g. documentation SHOWING the syntax) is
    neither a live suppression nor a reasonless-suppression finding —
    only actual ``#`` comments count."""
    out = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                out[tok.start[0]] = (rules, m.group(2))
    except (tokenize.TokenError, IndentationError):
        pass  # the ast parse will surface the real syntax problem
    return out


# ---------------------------------------------------------------------------
# scope policy: which rules look where

# Modules whose code runs inside the solve loops — the callback-gate,
# traced-branch, purity and static-default rules apply here.
_SOLVER_SCOPE = (
    "poisson_tpu_torch/solvers/",
    "poisson_tpu_torch/ops/",
    "poisson_tpu_torch/mg/",
    "poisson_tpu_torch/integrity/",
    "poisson_tpu_torch/parallel/",
    "poisson_tpu_torch/krylov/",
    "poisson_tpu_torch/obs/stream.py",
)
# The sanctioned host-read site: the stream sink copies its staged
# samples to the host at the driver's read of ``done``.
_SANCTIONED = ("poisson_tpu_torch/obs/stream.py",)

# Purity scope (wallclock/rng): solver math modules. Exempt by path:
# selfcheck smoke drivers (host-side harnesses), the watchdog (its whole
# job is wall-clock supervision of the solve from OUTSIDE the trace),
# multihost init (retry backoff timing is host-side by construction),
# and the stream sink's host half (it timestamps samples AFTER the
# gated callback has already left the device).
_PURITY_EXEMPT = ("selfcheck", "parallel/watchdog.py",
                  "parallel/multihost.py", "obs/stream.py")

# Host reads: methods that copy a tensor to the host, scalar
# conversions, and the device-wide sync.
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_READ_CASTS = {"float", "bool", "int"}
_HOST_SYNCS = {("torch", "cuda", "synchronize")}
# The solve drivers: what they call each step is a step body.
_DRIVERS = {"drive", "step_members"}
_FACTORY_RE = re.compile(r"^make_\w*(body|step)\w*$")

# JAX's static-default rule has two halves; the port keeps the first.
STATIC_DEFAULT_EXEMPTION = (
    "jit static-arg defaults: the port compiles no program keyed on its "
    "arguments (no jax.jit, no torch.compile), so there is no compile "
    "cache a mutable static default could split or poison; the "
    "mutable-default half of the rule stays")

_WALLCLOCK_CALLS = {
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"), ("datetime", "now"),
    ("datetime", "utcnow"),
}

_RNG_MODULES = {"random"}          # the stdlib module
_NP_RANDOM_UNSEEDED = {
    "random", "rand", "randn", "randint", "normal", "uniform",
    "choice", "permutation", "shuffle", "seed",
}


def _in_scope(rel: str, scopes: Iterable[str]) -> bool:
    return any(rel.startswith(s) or rel == s.rstrip("/") for s in scopes)


def _dotted(node: ast.AST):
    """A Call's func as a dotted name tuple, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# documented-name extraction (counter-doc rule)

_NAME_TOKEN = re.compile(
    r"[a-z][a-z0-9_]*(?:\.[a-z0-9_{},<>*]+)+", re.IGNORECASE)
_CODE_SPAN = re.compile(r"``([^`]+)``")


def _expand_doc_token(token: str, exact: set, prefixes: set) -> None:
    """Expand one documented token into exact names / wildcard prefixes.

    ``a.{x,y}.z`` alternates, ``a.<verdict>`` / ``a.{W}s`` wildcard the
    rest, a trailing ``.*`` is an explicit prefix wildcard.
    """
    m = re.search(r"\{([^{}]*,[^{}]*)\}", token)
    if m:
        for alt in m.group(1).split(","):
            _expand_doc_token(
                token[:m.start()] + alt.strip() + token[m.end():],
                exact, prefixes)
        return
    wild = re.search(r"[<{]", token)
    if wild:
        prefix = token[:wild.start()]
        if prefix:
            prefixes.add(prefix)
        return
    if token.endswith(".*"):
        prefixes.add(token[:-1])
        return
    exact.add(token)


def documented_metric_names(metrics_source: str) -> tuple:
    """(exact names, wildcard prefixes) documented in the
    ``obs/metrics.py`` module docstring's ````code```` spans."""
    doc = ast.get_docstring(ast.parse(metrics_source)) or ""
    exact: set = set()
    prefixes: set = set()
    for span in _CODE_SPAN.findall(doc):
        for token in _NAME_TOKEN.findall(span):
            _expand_doc_token(token, exact, prefixes)
    return exact, prefixes


def _metric_documented(name: str, exact: set, prefixes: set,
                       is_prefix: bool = False) -> bool:
    if is_prefix:
        # An f-string literal prefix: documented if any catalogued name
        # or pattern lives under it (or it lives under a pattern).
        return (any(e.startswith(name) for e in exact)
                or any(p.startswith(name) or name.startswith(p)
                       for p in prefixes))
    return name in exact or any(name.startswith(p) for p in prefixes)


def declared_flight_kinds(flight_source: str) -> set:
    """The ``SPAN_*``/``POINT_*`` string constants declared at
    ``obs/flight.py`` top level — the span/point kind taxonomy."""
    kinds = set()
    for node in ast.parse(flight_source).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (isinstance(t, ast.Name)
                    and re.match(r"^(SPAN|POINT)_", t.id)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                kinds.add(node.value.value)
    return kinds


# ---------------------------------------------------------------------------
# per-file lint


class _FileLint:
    def __init__(self, rel: str, source: str, ctx: dict):
        self.rel = rel
        self.source = source
        self.ctx = ctx
        self.tree = ast.parse(source)
        self.suppressions = _parse_suppressions(source)
        self.findings: list = []
        self.parent: dict = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        # from-import bindings, so `from time import perf_counter` /
        # `from torch import cuda` can't evade the module-qualified
        # rules: local name -> originating module path tuple.
        self.from_imports: dict = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                mod = tuple(node.module.split("."))
                for alias in node.names:
                    if alias.name != "*":
                        self.from_imports[alias.asname or alias.name] = \
                            mod + (alias.name,)

    # -- helpers --------------------------------------------------------

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        f = Finding(rule=rule, file=self.rel, line=line, col=col,
                    message=message)
        for cand in (line, line - 1):
            sup = self.suppressions.get(cand)
            if sup and (rule in sup[0] or "all" in sup[0]):
                f.suppressed = True
                f.reason = sup[1]
                break
        self.findings.append(f)

    def resolve_dotted(self, node: ast.AST):
        """Like :func:`_dotted`, but with the leading name expanded
        through this file's from-import bindings — ``perf_counter()``
        after ``from time import perf_counter`` resolves to
        ``('time', 'perf_counter')``, ``cuda.synchronize()`` after ``from torch import cuda`` to
        ``('torch', 'cuda', 'synchronize')``."""
        dotted = _dotted(node)
        if not dotted:
            return dotted
        expansion = self.from_imports.get(dotted[0])
        if expansion:
            return expansion + dotted[1:]
        return dotted

    def ancestors(self, node: ast.AST):
        cur = self.parent.get(node)
        while cur is not None:
            yield cur
            cur = self.parent.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def _resolve_local_fn(self, name: str, at_line: int):
        """Nearest preceding FunctionDef with this name (step bodies are
        local defs right above their driver call)."""
        best = None
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.FunctionDef) and node.name == name
                    and node.lineno <= at_line
                    and (best is None or node.lineno > best.lineno)):
                best = node
        return best

    # -- rules ----------------------------------------------------------

    def run(self) -> list:
        if _in_scope(self.rel, _SOLVER_SCOPE):
            if not _in_scope(self.rel, _SANCTIONED):
                self._rule_callback_gate()
            self._rule_traced_branch()
            if not any(tag in self.rel for tag in _PURITY_EXEMPT):
                self._rule_wallclock_and_rng()
            self._rule_static_default()
        self._rule_counter_doc()
        self._rule_flight_kind()
        if self.rel.endswith("testing/chaos.py"):
            self._rule_chaos_registry()
        if self.rel.endswith(("solvers/batched.py", "serve/service.py",
                              "serve/refill.py")):
            self._rule_fingerprint_key()
        self._rule_suppression_reason()
        return self.findings

    def step_bodies(self):
        """The step bodies of this file: local functions passed to a
        driver, and the functions ``make_*body*``/``make_*step*``
        factories return."""
        seen = set()
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Call) and node.args
                    and (_dotted(node.func) or ())[-1:] in
                    {(d,) for d in _DRIVERS}
                    and isinstance(node.args[0], ast.Name)):
                fn = self._resolve_local_fn(node.args[0].id, node.lineno)
                if fn is not None and id(fn) not in seen:
                    seen.add(id(fn))
                    yield fn
            elif (isinstance(node, ast.FunctionDef)
                  and _FACTORY_RE.match(node.name)):
                returned = {r.value.id for r in ast.walk(node)
                            if isinstance(r, ast.Return)
                            and isinstance(r.value, ast.Name)}
                for inner in ast.walk(node):
                    if (isinstance(inner, ast.FunctionDef)
                            and inner is not node
                            and inner.name in returned
                            and id(inner) not in seen):
                        seen.add(id(inner))
                        yield inner

    def _host_read(self, node: ast.Call, params: set):
        """The host read ``node`` performs, or None."""
        dotted = self.resolve_dotted(node.func)
        if dotted in _HOST_SYNCS:
            return ".".join(dotted)
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_READ_METHODS):
            return f".{node.func.attr}()"
        if (isinstance(node.func, ast.Name)
                and node.func.id in _HOST_READ_CASTS
                and len(node.args) == 1):
            arg = node.args[0]
            names = {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
            torch_call = any(
                isinstance(c, ast.Call)
                and (self.resolve_dotted(c.func) or ("",))[0] == "torch"
                for c in ast.walk(arg))
            if names & params or torch_call:
                return f"{node.func.id}(...)"
        return None

    def _rule_callback_gate(self) -> None:
        for fn in self.step_bodies():
            params = {a.arg for a in fn.args.args}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                read = self._host_read(node, params)
                if read is None or self._is_gated(node, fn):
                    continue
                self.emit(
                    "callback-gate", node,
                    f"host read `{read}` in step body `{fn.name}` without "
                    f"a static-flag gate — it waits for the device every "
                    f"step; wrap it in `if <static_flag>:` or leave it to "
                    f"the driver's read of `done`")

    def _is_gated(self, node: ast.AST, fn: ast.FunctionDef) -> bool:
        """Gated = under a Python ``if`` inside the body (a static flag
        chosen when the body was built)."""
        for anc in self.ancestors(node):
            if anc is fn:
                return False
            if isinstance(anc, ast.If):
                return True
        return False

    @staticmethod
    def _value_test(test: ast.AST) -> bool:
        """Whether a branch test reads a value (not an ``is None``
        identity test, ``isinstance`` or ``hasattr``)."""
        if (isinstance(test, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in test.ops)):
            return False
        if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
                and test.func.id in ("isinstance", "hasattr")):
            return False
        return True

    def _rule_traced_branch(self) -> None:
        for fn in self.step_bodies():
            params = {a.arg for a in fn.args.args}
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                hit = {n.id for n in ast.walk(node.test)
                       if isinstance(n, ast.Name)} & params
                if hit and self._value_test(node.test):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    self.emit(
                        "traced-branch", node,
                        f"Python `{kind}` on the loop state "
                        f"{sorted(hit)} inside step body `{fn.name}` — a "
                        f"hidden host sync every step; select with "
                        f"`torch.where` and leave the read to the driver")

    def _rule_wallclock_and_rng(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = self.resolve_dotted(node.func)
            if not dotted:
                continue
            if dotted[-2:] in _WALLCLOCK_CALLS or dotted in _WALLCLOCK_CALLS:
                self.emit(
                    "wallclock", node,
                    f"wall-clock read `{'.'.join(dotted)}` in solver "
                    f"code — clocks are hidden inputs (trace-unsafe in "
                    f"a body, nondeterministic in setup); take times at "
                    f"the obs/ layer")
                continue
            is_std_rng = (len(dotted) == 2 and dotted[0] in _RNG_MODULES
                          and dotted[1] != "Random")
            is_np_rng = (len(dotted) >= 3
                         and dotted[-3:-1] in {("np", "random"),
                                               ("numpy", "random")}
                         and dotted[-1] in _NP_RANDOM_UNSEEDED)
            if is_std_rng or is_np_rng:
                self.emit(
                    "rng", node,
                    f"unseeded RNG `{'.'.join(dotted)}` in solver code "
                    f"— solver paths must be deterministic; thread a "
                    f"seeded `default_rng(seed)` from the caller")

    def _rule_static_default(self) -> None:
        for fn in ast.walk(self.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            # args.defaults spans posonlyargs + args; kw-only params
            # carry their own kw_defaults list (None = no default).
            pos_params = fn.args.posonlyargs + fn.args.args
            defaults = fn.args.defaults
            defaulted = list(zip(
                pos_params[len(pos_params) - len(defaults):], defaults))
            defaulted += [(p, d) for p, d in
                          zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                          if d is not None]
            for param, default in defaulted:
                bad = self._mutable_default(default)
                if bad is not None:
                    self.emit(
                        "static-default", default,
                        f"mutable default `{param.arg}={bad}` on "
                        f"`{fn.name}` — shared across calls; default to "
                        f"None and build inside")

    @staticmethod
    def _mutable_default(node: ast.AST):
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return {ast.List: "list literal", ast.Dict: "dict literal",
                    ast.Set: "set literal"}[type(node)]
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ("call",)
            # frozen/hashable constructors are fine
            if dotted[-1] in {"tuple", "frozenset", "MGConfig",
                              "RetryPolicy", "BreakerPolicy",
                              "DegradationPolicy", "SLOPolicy",
                              "FleetPolicy", "IntegrityPolicy",
                              "ServicePolicy"}:
                return None
            return f"call to {'.'.join(dotted)}()"
        return None

    def _rule_counter_doc(self) -> None:
        exact, prefixes = self.ctx["metric_names"]
        if self.rel.endswith("obs/metrics.py"):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            dotted = _dotted(node.func) or ()
            if dotted[-1:] not in {("inc",), ("gauge",), ("observe",)}:
                continue
            if len(dotted) >= 2 and not re.search(
                    r"(obs|metrics)", dotted[-2], re.IGNORECASE):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name, is_prefix = arg.value, False
            elif isinstance(arg, ast.JoinedStr):
                head = arg.values[0] if arg.values else None
                if not (isinstance(head, ast.Constant)
                        and isinstance(head.value, str)):
                    continue
                name, is_prefix = head.value, True
            else:
                continue
            if not _metric_documented(name, exact, prefixes, is_prefix):
                kind = "family prefix" if is_prefix else "name"
                self.emit(
                    "counter-doc", node,
                    f"metric {kind} `{name}` is not documented in "
                    f"obs/metrics.py — the docstring catalogue is the "
                    f"metrics contract; add it (with semantics) or "
                    f"rename onto a documented family")

    def _rule_flight_kind(self) -> None:
        kinds = self.ctx["flight_kinds"]
        if self.rel.endswith("obs/flight.py"):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call) or len(node.args) < 2:
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in {"begin", "end", "point"}):
                continue
            recv = _dotted(func.value) or ()
            recv_txt = ".".join(recv).lower()
            if not ("flight" in recv_txt or "recorder" in recv_txt):
                continue
            arg = node.args[1]
            if (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value not in kinds):
                self.emit(
                    "flight-kind", node,
                    f"flight span/point kind '{arg.value}' is not "
                    f"declared in obs/flight.py — add a SPAN_*/POINT_* "
                    f"constant (the span taxonomy is the contract the "
                    f"trace viewer and tests validate against)")

    def _rule_chaos_registry(self) -> None:
        for node in self.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            args = node.args
            if (len(args.args) != 1 or args.args[0].arg != "seed"
                    or args.vararg or args.kwarg or args.kwonlyargs):
                continue
            registered = any(
                isinstance(dec, ast.Call)
                and (_dotted(dec.func) or ())[-1:] == ("scenario",)
                for dec in node.decorator_list)
            if not registered:
                self.emit(
                    "chaos-registry", node,
                    f"`{node.name}(seed)` looks like a chaos scenario "
                    f"but carries no @scenario(...) decorator — it "
                    f"would never join the --list catalogue or the "
                    f"campaign (`chaos --all` silently skips it)")

    def _rule_fingerprint_key(self) -> None:
        key_fns = {"_cohort", "_lane_cohort", "_hw_cohort",
                   "taint_compatible"}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
                if not any("key" in n for n in names):
                    continue
                hit = self._fingerprint_refs(node.value)
                if hit:
                    self.emit(
                        "fingerprint-key", node,
                        f"`{hit}` flows into key `{names[0]}` — "
                        f"fingerprints are operand identity, never "
                        f"executable/cohort identity (the PR 9 "
                        f"invariant: geometry families co-batch on one "
                        f"bucket executable)")
            elif (isinstance(node, ast.FunctionDef)
                  and node.name in key_fns
                  and node.name != "taint_compatible"):
                for stmt in node.body:
                    if isinstance(stmt, ast.Return) and stmt.value:
                        hit = self._fingerprint_refs(stmt.value)
                        if hit:
                            self.emit(
                                "fingerprint-key", stmt,
                                f"cohort builder `{node.name}` returns "
                                f"a value referencing `{hit}` — "
                                f"fingerprints must never split "
                                f"cohorts (families co-batch)")

    @staticmethod
    def _fingerprint_refs(node: ast.AST):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and (
                    "fingerprint" in sub.id or sub.id == "taint_fp"):
                return sub.id
            if isinstance(sub, ast.Attribute) and (
                    "fingerprint" in sub.attr or sub.attr == "taint_fp"):
                return sub.attr
        return None

    def _rule_suppression_reason(self) -> None:
        for line_no, (rules, reason) in self.suppressions.items():
            if reason is None or not reason.strip():
                self.findings.append(Finding(
                    rule="suppression-reason", file=self.rel,
                    line=line_no, col=0,
                    message=(
                        f"suppression for {sorted(rules)} has no reason "
                        f"string — write `# contracts: allow=<rule> -- "
                        f"<why this is safe>`"),
                ))


# ---------------------------------------------------------------------------
# tree walk + report

RULES = (
    "callback-gate", "traced-branch", "static-default", "wallclock",
    "rng", "counter-doc", "flight-kind", "chaos-registry",
    "fingerprint-key", "suppression-reason",
)

_SCAN_ROOTS = ("poisson_tpu_torch",)
_SCAN_FILES = ()
_SKIP_PARTS = ("__pycache__",)


def _iter_sources(root: str):
    for top in _SCAN_ROOTS:
        base = os.path.join(root, top)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_PARTS]
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    yield os.path.join(dirpath, fname)
    for fname in _SCAN_FILES:
        path = os.path.join(root, fname)
        if os.path.isfile(path):
            yield path


def _build_context(root: str) -> dict:
    def read(rel):
        try:
            with open(os.path.join(root, rel)) as f:
                return f.read()
        except OSError:
            return ""

    return {
        "metric_names": documented_metric_names(
            read("poisson_tpu_torch/obs/metrics.py")),
        "flight_kinds": declared_flight_kinds(
            read("poisson_tpu_torch/obs/flight.py")),
    }


def lint_source(rel: str, source: str, ctx: Optional[dict] = None) -> list:
    """Lint one source string (the unit-test seam). ``ctx`` defaults to
    empty catalogues — pass :func:`_build_context`'s output (or a
    doctored one) to exercise the catalogue-backed rules."""
    ctx = ctx or {"metric_names": (set(), set()), "flight_kinds": set()}
    return _FileLint(rel, source, ctx).run()


def run_lint(root: Optional[str] = None) -> dict:
    """Lint the tree; returns the machine-readable report dict."""
    root = os.path.abspath(root or repo_root())
    ctx = _build_context(root)
    findings: list = []
    files = 0
    for path in _iter_sources(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path) as f:
                source = f.read()
        except OSError:
            continue
        try:
            findings.extend(_FileLint(rel, source, ctx).run())
        except SyntaxError as e:
            findings.append(Finding(
                rule="parse", file=rel, line=e.lineno or 1, col=0,
                message=f"source does not parse: {e.msg}"))
        files += 1
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    active = [f for f in findings if not f.suppressed]
    return {
        "schema": "poisson_tpu_torch.contracts.lint/1",
        "root": root,
        "files": files,
        "rules": list(RULES),
        "findings": [asdict(f) for f in findings],
        "counts": {
            "findings": len(active),
            "suppressed": len(findings) - len(active),
            "rules": len(RULES),
        },
    }


def repo_root() -> str:
    """The checkout root: the directory that holds the package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
