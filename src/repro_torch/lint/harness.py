"""Pass 2 — harness lint: AST checks for timing pitfalls, in torch's idioms.

A *timed region* is the span between ``t0 = <clock>()`` and the last
statement subtracting ``t0`` in the same statement block — the
gettimeofday-around-the-kernel pattern the paper (and ``timed_sampler``)
uses. The codes and scope rules are the JAX package's
(``repro.lint.harness``); what counts as device work and as a sync is
PyTorch's:

- **device work**: a ``torch.*`` call that computes (not the
  ``torch.cuda``/``torch.backends``/``torch.profiler``/... utilities),
  a call to one of the port's kernel wrappers (``triad``, ``matmul``,
  ``flash_attention``, ``ssd_chunk_scan``, ``chunk_scan``), or a call of
  a callable bound from ``<cache>.compile(...)``/``torch.compile(...)``;
- **stream-wide syncs**: ``torch.cuda.synchronize()``, ``.synchronize()``
  on a stream or event, a callable bound from the port's
  ``synchronizer(dev)``, and a ``CardClock`` sample (``.measure``);
- **tensor syncs**: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``
  — they wait for the tensor they read.

Within and around timed regions this pass flags:

  MS201  region performs device work with no sync before the clock
         stops — asynchronous launches mean the measured time excludes
         the actual compute
  MS202  ``time.time()`` in a timing path (wall clock, not monotonic;
         timestamps outside subtraction chains are fine)
  MS203  ``torch.compile`` or a kernel build (``build.kernel_fn``,
         ``build.library``) inside a loop in a timed region —
         compilation is timed as if it were kernel work
  MS204  a device computation's result discarded inside a timed region
         whose only syncs are tensor syncs — nothing waits for it
  MS205  unseeded RNG: the numpy and stdlib legacy module functions,
         and ``torch.rand*``/``randn*``/``randint*``/``randperm``/
         ``normal`` called without ``generator=`` (the global torch
         generator) — benchmark data must be reproducible
  MS206  a tensor sync on one name of a multi-output unpacking whose
         sibling outputs are used later, with no stream-wide sync — the
         clock stops while the unsynced outputs may still be computing
  MS207  ``torch.compile`` or a kernel build invoked directly inside an
         *invocation factory* (a scope named ``factory``/
         ``make_invocation``, or one returning a ``timed_sampler``/
         ``steady_sampler``) — the factory runs once per outer-loop
         invocation; resolve kernels through
         ``repro_torch.core.ExecutableCache`` instead

Opaque calls (``fn()``, ``tuner.tune()``) are trusted to sync
internally, so timing wrappers over callbacks do not false-positive.
Suppress intentional exceptions with ``# lint: ok=MS2xx`` on the flagged
line.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Iterator, Optional

from .findings import Finding, make_finding

__all__ = ["lint_file", "lint_paths", "lint_source"]

_CLOCKS = {
    "time.time", "time.time_ns", "time.clock",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
}
_WALL_CLOCKS = {"time.time", "time.time_ns", "time.clock"}

_SEEDED_NUMPY = {"default_rng", "Generator", "SeedSequence", "RandomState",
                 "BitGenerator", "PCG64", "MT19937", "Philox", "SFC64"}
_SEEDED_STDLIB = {"Random", "SystemRandom", "seed", "getstate", "setstate"}
#: torch's sampling functions that draw from the global generator unless
#: given ``generator=``
_TORCH_RNG = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal"}

#: ``torch.*`` namespaces and functions that launch no device work
_TORCH_UTILITY_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.profiler.", "torch.utils.",
    "torch.autograd.profiler.", "torch.library.", "torch.distributed.",
    "torch.testing.", "torch.nn.init.", "torch._C.", "torch.jit.")
_TORCH_UTILITIES = {
    "torch.device", "torch.dtype", "torch.Generator", "torch.no_grad",
    "torch.enable_grad", "torch.inference_mode", "torch.manual_seed",
    "torch.compile", "torch.is_tensor", "torch.is_grad_enabled",
    "torch.get_default_dtype", "torch.set_default_dtype",
    "torch.set_grad_enabled", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.from_numpy", "torch.get_num_threads", "torch.set_num_threads",
    "torch.use_deterministic_algorithms", "torch.cuda"}
#: the port's kernel wrappers (``repro_torch.kernels``)
_KERNEL_WRAPPERS = {"triad", "matmul", "flash_attention", "ssd_chunk_scan",
                    "chunk_scan"}
_TENSOR_SYNCS = {"item", "cpu", "tolist", "numpy"}


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base is not None else None
    return None


def _walk_stmts(stmts: list[ast.stmt]) -> Iterator[ast.stmt]:
    """Statements of one scope, descending control flow but not defs."""
    for st in stmts:
        yield st
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(st, field, None)
            if sub:
                yield from _walk_stmts(sub)
        for handler in getattr(st, "handlers", ()):
            yield from _walk_stmts(handler.body)


def _child_functions(stmts: list[ast.stmt]) -> Iterator[ast.AST]:
    """Function scopes directly inside this scope (class bodies are
    transparent: methods chain to the enclosing module scope)."""
    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield st
        elif isinstance(st, ast.ClassDef):
            yield from _child_functions(st.body)
        else:
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if sub:
                    yield from _child_functions(sub)
            for handler in getattr(st, "handlers", ()):
                yield from _child_functions(handler.body)


def _subtracts(st: ast.stmt, name: str) -> bool:
    """Does this statement compute ``... - name`` (or ``name - ...``)?"""
    for node in ast.walk(st):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            for side in (node.left, node.right):
                if isinstance(side, ast.Name) and side.id == name:
                    return True
    return False


def _is_build(name: Optional[str]) -> bool:
    """``torch.compile`` or a kernel build of ``repro_torch.kernels.build``."""
    if name is None:
        return False
    return name == "torch.compile" or name.endswith("build.kernel_fn") \
        or name.endswith("build.library")


def _method(call: ast.Call) -> Optional[str]:
    """The attribute a method call names (``x.item()`` -> ``item``)."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else None


class _Bound:
    """Names a scope binds to compiled callables, synchronizers and card
    clocks; inherited by nested scopes."""

    def __init__(self, compiled=(), syncs=(), clocks=()):
        self.compiled = set(compiled)
        self.syncs = set(syncs)
        self.clocks = set(clocks)

    def copy(self) -> "_Bound":
        return _Bound(self.compiled, self.syncs, self.clocks)


class _Scope:
    """Timed-region analysis of one function (or the module body)."""

    def __init__(self, linter: "_FileLinter", node: ast.AST, bound: _Bound):
        self.linter = linter
        self.node = node
        self.bound = bound.copy()

    # -- name resolution ------------------------------------------------------
    def resolve(self, dotted: Optional[str]) -> Optional[str]:
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        full = self.linter.aliases.get(head, head)
        return f"{full}.{rest}" if rest else full

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.resolve(_dotted(call.func))

    def is_clock(self, node: ast.AST) -> Optional[str]:
        """Resolved clock name when ``node`` is a clock call."""
        if not isinstance(node, ast.Call):
            return None
        name = self.call_name(node)
        if name in _CLOCKS:
            return name
        # injected clocks (``self.clock()``, ``clock()``): treated monotonic
        if name is not None and (name == "clock" or name.endswith(".clock")):
            return "clock"
        return None

    def is_stream_sync(self, call: ast.Call) -> bool:
        """A sync that waits for every launch queued before it."""
        name = self.call_name(call)
        if _method(call) == "synchronize":
            return True
        if name is not None and name.split(".")[0] in self.bound.syncs:
            return True
        if _method(call) == "measure" and isinstance(call.func, ast.Attribute):
            recv = _dotted(call.func.value) or ""
            leaf = recv.rsplit(".", 1)[-1]
            return leaf in self.bound.clocks or "card" in leaf
        return False

    def is_tensor_sync(self, call: ast.Call) -> bool:
        return _method(call) in _TENSOR_SYNCS and not call.args

    def is_sync(self, call: ast.Call) -> bool:
        return self.is_stream_sync(call) or self.is_tensor_sync(call)

    def is_device_call(self, call: ast.Call) -> bool:
        """Does this call visibly launch device work? Opaque calls
        (plain callbacks) are trusted to sync internally."""
        name = self.call_name(call)
        if name is None or self.is_sync(call):
            return False
        if name.startswith("torch."):
            return name not in _TORCH_UTILITIES and \
                not name.startswith(_TORCH_UTILITY_PREFIXES)
        parts = name.split(".")
        if parts[-1] in _KERNEL_WRAPPERS and (
                len(parts) == 1 and parts[0] in self.linter.kernel_names
                or "kernels" in parts[:-1]):
            return True
        return parts[0] in self.bound.compiled

    # -- scanning -------------------------------------------------------------
    def scan(self) -> None:
        body = getattr(self.node, "body", [])
        self._collect_bound(body)
        self._check_factory_build(body)
        for block in self._blocks(body):
            self._scan_block(block)

    # -- MS207: invocation factories must use the executable cache -----------
    def _is_invocation_factory(self) -> bool:
        """An invocation-factory scope: named like one, or returning a
        sampler constructed by ``timed_sampler``/``steady_sampler``."""
        node = self.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        if node.name in ("factory", "make_invocation"):
            return True
        for st in _walk_stmts(node.body):
            if isinstance(st, ast.Return) and isinstance(st.value, ast.Call):
                name = self.call_name(st.value)
                leaf = name.rsplit(".", 1)[-1] if name else ""
                if leaf in ("timed_sampler", "steady_sampler"):
                    return True
        return False

    def _check_factory_build(self, stmts: list[ast.stmt]) -> None:
        if not self._is_invocation_factory():
            return
        for st in _walk_stmts(stmts):
            for node in ast.walk(st):
                if isinstance(node, ast.Call) \
                        and _is_build(self.call_name(node)):
                    self._flag("MS207", node,
                               f"{self.call_name(node)} inside an "
                               f"invocation factory re-compiles or re-binds "
                               f"the kernel every outer-loop invocation — "
                               f"resolve it once through "
                               f"ExecutableCache.compile (see "
                               f"repro_torch.core.exec_cache)")

    def _collect_bound(self, stmts: list[ast.stmt]) -> None:
        """Names bound to compiled callables (``f = cache.compile(g,
        args)``, ``f = torch.compile(g)``), synchronizers (``sync =
        synchronizer(dev)``) and card clocks (``card = CardClock()``)."""
        for st in _walk_stmts(stmts):
            if not (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)
                    and isinstance(st.value, ast.Call)):
                continue
            target = st.targets[0].id
            name = self.call_name(st.value) or ""
            leaf = name.rsplit(".", 1)[-1]
            if _method(st.value) == "compile" or name == "torch.compile":
                self.bound.compiled.add(target)
            elif leaf == "synchronizer":
                self.bound.syncs.add(target)
            elif leaf == "CardClock":
                self.bound.clocks.add(target)

    def _blocks(self, stmts: list[ast.stmt]) -> Iterator[list[ast.stmt]]:
        """Every statement list in this scope, stopping at nested defs."""
        yield stmts
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if sub:
                    yield from self._blocks(sub)
            for handler in getattr(st, "handlers", ()):
                yield from self._blocks(handler.body)

    def _scan_block(self, stmts: list[ast.stmt]) -> None:
        for i, st in enumerate(stmts):
            if not (isinstance(st, ast.Assign) and len(st.targets) == 1
                    and isinstance(st.targets[0], ast.Name)):
                continue
            clock = self.is_clock(st.value)
            if clock is None:
                continue
            t0 = st.targets[0].id
            limit = len(stmts)   # a later ``t0 = clock()`` starts a new region
            for j in range(i + 1, len(stmts)):
                nxt = stmts[j]
                if isinstance(nxt, ast.Assign) \
                        and any(isinstance(t, ast.Name) and t.id == t0
                                for t in nxt.targets):
                    limit = j
                    break
            ends = [j for j in range(i + 1, limit)
                    if _subtracts(stmts[j], t0)]
            if not ends:
                continue   # never differenced: a timestamp, not a timer
            if clock in _WALL_CLOCKS:
                self._flag("MS202", st,
                           f"{t0} = {clock}(): wall clock in a timing "
                           f"path; use time.perf_counter")
            region = stmts[i + 1:ends[-1] + 1]
            self._check_region(region, stmts[ends[-1]], stmts[ends[-1] + 1:])

    def _check_region(self, region: list[ast.stmt], end: ast.stmt,
                      after: list[ast.stmt]) -> None:
        device_calls: list[ast.Call] = []
        syncs: list[ast.Call] = []
        stream_synced = False
        for st in region:
            for node in ast.walk(st):
                if not isinstance(node, ast.Call):
                    continue
                if self.is_sync(node):
                    syncs.append(node)
                    stream_synced |= self.is_stream_sync(node)
                elif self.is_device_call(node):
                    device_calls.append(node)
                if st is end and self.call_name(node) in _WALL_CLOCKS:
                    self._flag("MS202", node,
                               "time.time() closes a timed region; "
                               "use time.perf_counter")
        if device_calls and not syncs:
            self._flag("MS201", end,
                       "timed region launches device work (line "
                       f"{device_calls[0].lineno}) but never synchronizes "
                       "before reading the clock")
        for st in region:
            if syncs and not stream_synced and isinstance(st, ast.Expr) \
                    and isinstance(st.value, ast.Call) \
                    and self.is_device_call(st.value):
                self._flag("MS204", st,
                           "device computation result discarded inside a "
                           "timed region whose syncs wait on other tensors "
                           "only — bind it and sync it, or synchronize the "
                           "stream")
            for loop in ast.walk(st):
                if isinstance(loop, (ast.For, ast.While)):
                    for node in ast.walk(loop):
                        if isinstance(node, ast.Call) \
                                and _is_build(self.call_name(node)):
                            self._flag("MS203", node,
                                       f"{self.call_name(node)} invoked "
                                       f"inside a timed loop — compilation "
                                       f"is measured as if it were kernel "
                                       f"time")
        if not stream_synced:
            self._check_partial_sync(region, after, syncs)

    def _check_partial_sync(self, region: list[ast.stmt],
                            after: list[ast.stmt],
                            syncs: list[ast.Call]) -> None:
        unpacked: dict[str, set[str]] = {}
        for st in region:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Tuple) \
                    and isinstance(st.value, ast.Call) \
                    and self.is_device_call(st.value):
                names = {e.id for e in st.targets[0].elts
                         if isinstance(e, ast.Name)}
                for n in names:
                    unpacked[n] = names
        if not unpacked:
            return
        used_after = {node.id for st in after for node in ast.walk(st)
                      if isinstance(node, ast.Name)
                      and isinstance(node.ctx, ast.Load)}
        for sync in syncs:
            recv = sync.func.value if isinstance(sync.func, ast.Attribute) \
                else None
            if not isinstance(recv, ast.Name):
                continue
            synced = recv.id
            siblings = unpacked.get(synced, set()) - {synced}
            stale = sorted(siblings & used_after)
            if stale:
                self._flag("MS206", sync,
                           f"{synced}.{sync.func.attr}() leaves sibling "
                           f"output(s) {', '.join(stale)} unsynced but used "
                           f"later — synchronize the stream so the timed "
                           f"region covers all outputs")

    def _flag(self, code: str, node: ast.AST, message: str) -> None:
        self.linter.findings.append(make_finding(
            code, self.linter.path, getattr(node, "lineno", 0), message))


class _FileLinter:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.aliases: dict[str, str] = {}
        #: local names imported from a ``kernels`` package (relative or not)
        self.kernel_names: set[str] = set()
        self.findings: list[Finding] = []
        self._collect_imports()

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                module = node.module or ""
                if node.level == 0 and module:
                    for a in node.names:
                        self.aliases[a.asname or a.name] = \
                            f"{module}.{a.name}"
                elif module:
                    # relative import: keep the module path, dots dropped
                    for a in node.names:
                        self.aliases[a.asname or a.name] = \
                            f"{module}.{a.name}"
                if "kernels" in module.split("."):
                    self.kernel_names.update(
                        a.asname or a.name for a in node.names
                        if a.name in _KERNEL_WRAPPERS)

    def run(self) -> list[Finding]:
        self._visit_scope(self.tree, _Bound())
        self._check_rng()
        return self.findings

    def _visit_scope(self, node: ast.AST, bound: _Bound) -> None:
        scope = _Scope(self, node, bound)
        scope.scan()
        for fn in _child_functions(getattr(node, "body", [])):
            self._visit_scope(fn, scope.bound)

    def _check_rng(self) -> None:
        scope = _Scope(self, self.tree, _Bound())
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = scope.call_name(node)
            if name is None or "." not in name:
                continue
            head, leaf = name.rsplit(".", 1)
            if head in ("numpy.random", "np.random") \
                    and leaf not in _SEEDED_NUMPY:
                self.findings.append(make_finding(
                    "MS205", self.path, node.lineno,
                    f"{name}: legacy global-state RNG — benchmark data "
                    f"must come from a seeded numpy Generator "
                    f"(default_rng(seed))"))
            elif head == "random" and leaf not in _SEEDED_STDLIB:
                self.findings.append(make_finding(
                    "MS205", self.path, node.lineno,
                    f"{name}: unseeded stdlib RNG — use a seeded "
                    f"random.Random(seed) instance"))
            elif head == "torch" and leaf in _TORCH_RNG \
                    and not any(k.arg == "generator" for k in node.keywords):
                self.findings.append(make_finding(
                    "MS205", self.path, node.lineno,
                    f"{name} without generator=: draws from torch's global "
                    f"generator — pass a seeded torch.Generator"))


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [make_finding("MS104", path, e.lineno or 0,
                             f"file does not parse: {e.msg}")]
    return _FileLinter(path, tree).run()


def lint_file(path: str | Path) -> list[Finding]:
    return lint_source(Path(path).read_text(encoding="utf-8"), str(path))


def lint_paths(paths: Iterable[str | Path],
               exclude: Iterable[str] = ()) -> list[Finding]:
    """Lint every ``*.py`` under the given files/directories."""
    out: list[Finding] = []
    skip = tuple(exclude)
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            if any(s in str(f) for s in skip):
                continue
            out.extend(lint_file(f))
    return out
