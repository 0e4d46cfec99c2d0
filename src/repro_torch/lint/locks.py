"""Pass 3 — lock discipline: concurrency invariants of shared JSONL stores.

The trial cache and the run ledger are *shared files*: multiple processes
(parallel sessions, a compaction, a perf-gate report) may touch the same
path concurrently. The repo's protocol for that — established by
:class:`repro_torch.history.ledger.RunLedger` — has three invariants this pass
encodes as checks over the AST of the store modules:

  MS301  every write-mode ``open(self.path, ...)`` / ``os.replace(...,
         self.path)`` happens in a function that holds the exclusive
         advisory ``flock`` itself or runs inside a ``with
         self.<helper>()`` whose helper does
  MS302  when the module atomically replaces the shared file
         (``os.replace``), the flock-holding open helper must re-check
         the inode after locking (``os.fstat`` vs ``os.stat``) — an
         flock on a replaced inode serializes nothing
  MS303  rewrites must be crash-safe: never ``open(self.path, "w")`` in
         place, and every ``os.replace`` onto the shared path must
         ``os.fsync`` the temp file first

The *shared path* is recognized structurally: any expression ending in the
configured attribute (default ``.path`` — ``self.path``,
``self.ledger.path``, ...). Temp siblings (``self.path.with_name(...)``
bound to a local) are not shared. Read-mode opens are unchecked: JSONL
readers tolerate torn trailing lines by design.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Optional

from .findings import Finding, make_finding

__all__ = ["DEFAULT_LOCK_TARGETS", "check_lock_discipline",
           "check_lock_source"]

#: the modules whose on-disk stores are shared across processes
DEFAULT_LOCK_TARGETS = ("src/repro_torch/core/cache.py",
                        "src/repro_torch/history/ledger.py")

_WRITE_MODES = {"a", "a+", "ab", "a+b", "w", "w+", "wb", "w+b", "r+", "r+b"}
_TRUNCATE_MODES = {"w", "w+", "wb", "w+b"}

_COMPOUND_HEADERS = ("test", "iter", "target", "subject")


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def _is_shared(node: ast.AST, attr: str) -> bool:
    """Is this expression the shared store path (``*.{attr}``)?"""
    text = _unparse(node)
    return text == attr or text.endswith(f".{attr}")


def _open_mode(call: ast.Call) -> Optional[str]:
    """The mode of an ``open`` call, "r" when omitted, None if dynamic."""
    mode: ast.AST
    if len(call.args) >= 2:
        mode = call.args[1]
    else:
        kw = {k.arg: k.value for k in call.keywords}
        if "mode" not in kw:
            return "r"
        mode = kw["mode"]
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


def _call_name(call: ast.Call) -> str:
    return _unparse(call.func)


def _has_call(node: ast.AST, *names: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _call_name(sub) in names:
            return True
    return False


def _holds_flock(fn: ast.AST) -> bool:
    """Does this function itself take an exclusive flock?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _call_name(node).endswith("flock"):
            if any("LOCK_EX" in _unparse(a) for a in node.args):
                return True
    return False


class _ModuleChecker:
    def __init__(self, path: str, tree: ast.Module, attr: str):
        self.path = path
        self.tree = tree
        self.attr = attr
        self.findings: list[Finding] = []
        self.functions = [n for n in ast.walk(tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        self.flock_helpers = {fn.name for fn in self.functions
                              if _holds_flock(fn)}
        self.module_replaces_shared = any(
            isinstance(n, ast.Call) and _call_name(n) == "os.replace"
            and len(n.args) >= 2 and _is_shared(n.args[1], attr)
            for n in ast.walk(tree))

    def run(self) -> list[Finding]:
        for fn in self.functions:
            self._check_function(fn)
        return self.findings

    def _check_function(self, fn: ast.AST) -> None:
        holds = _holds_flock(fn)
        has_fsync = _has_call(fn, "os.fsync")
        self._scan_block(fn.body, fn, locked=holds, has_fsync=has_fsync)
        if holds and self.module_replaces_shared \
                and self._opens_shared(fn) \
                and not (_has_call(fn, "os.fstat")
                         and _has_call(fn, "os.stat")):
            self.findings.append(make_finding(
                "MS302", self.path, fn.lineno,
                f"{fn.name}: holds the flock on a file the module "
                f"os.replace()s, but never re-checks the inode "
                f"(os.fstat vs os.stat) after locking — a lock on the "
                f"orphaned inode serializes nothing"))

    def _opens_shared(self, fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _call_name(node) == "open" \
                    and node.args and _is_shared(node.args[0], self.attr):
                return True
        return False

    def _blessed(self, with_stmt: ast.AST) -> bool:
        """Does this ``with`` enter a flock-holding helper context?"""
        for item in with_stmt.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                leaf = _call_name(ctx).rsplit(".", 1)[-1]
                if leaf in self.flock_helpers:
                    return True
        return False

    def _scan_block(self, stmts: list[ast.stmt], fn: ast.AST,
                    locked: bool, has_fsync: bool) -> None:
        """Walk one statement block tracking whether an flock is held.

        ``with`` statements are the only lock-state transition; simple
        statements cannot contain one, so checking their calls via
        ``ast.walk`` never crosses a lock boundary."""
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue   # nested defs are checked as their own functions
            if isinstance(st, (ast.With, ast.AsyncWith)):
                inner = locked or self._blessed(st)
                for item in st.items:   # items evaluate under the OUTER state
                    self._check_calls(item.context_expr, fn, locked,
                                      has_fsync)
                self._scan_block(st.body, fn, inner, has_fsync)
                continue
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While, ast.If,
                               ast.Try)):
                for field in _COMPOUND_HEADERS:
                    sub = getattr(st, field, None)
                    if sub is not None:
                        self._check_calls(sub, fn, locked, has_fsync)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if sub:
                        self._scan_block(sub, fn, locked, has_fsync)
                for handler in getattr(st, "handlers", ()):
                    self._scan_block(handler.body, fn, locked, has_fsync)
                continue
            self._check_calls(st, fn, locked, has_fsync)

    def _check_calls(self, node: ast.AST, fn: ast.AST,
                     locked: bool, has_fsync: bool) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_call(sub, fn, locked, has_fsync)

    def _check_call(self, node: ast.Call, fn: ast.AST,
                    locked: bool, has_fsync: bool) -> None:
        name = _call_name(node)
        fn_name = getattr(fn, "name", "?")
        if name == "open" and node.args \
                and _is_shared(node.args[0], self.attr):
            mode = _open_mode(node)
            if mode is not None and mode not in _WRITE_MODES:
                return
            if mode in _TRUNCATE_MODES:
                self.findings.append(make_finding(
                    "MS303", self.path, node.lineno,
                    f"{fn_name}: open(..{self.attr}, {mode!r}) truncates "
                    f"the shared store in place — a crash mid-write "
                    f"destroys it; write a temp sibling, fsync, then "
                    f"os.replace"))
            if not locked:
                self.findings.append(make_finding(
                    "MS301", self.path, node.lineno,
                    f"{fn_name}: write-mode open of the shared store "
                    f"outside an exclusive flock — concurrent processes "
                    f"can interleave or lose records; hold "
                    f"fcntl.flock(LOCK_EX) across the write"))
        elif name == "os.replace" and len(node.args) >= 2 \
                and _is_shared(node.args[1], self.attr):
            if not locked:
                self.findings.append(make_finding(
                    "MS301", self.path, node.lineno,
                    f"{fn_name}: os.replace onto the shared store outside "
                    f"the flock — a concurrent locked appender may still "
                    f"write to the old inode"))
            if not has_fsync:
                self.findings.append(make_finding(
                    "MS303", self.path, node.lineno,
                    f"{fn_name}: os.replace onto the shared store without "
                    f"os.fsync on the temp file — a crash can atomically "
                    f"install empty or partial data"))


def check_lock_source(source: str, path: str = "<string>",
                      attr: str = "path") -> list[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [make_finding("MS104", path, e.lineno or 0,
                             f"file does not parse: {e.msg}")]
    return _ModuleChecker(path, tree, attr).run()


def check_lock_discipline(paths: Iterable[str | Path] = DEFAULT_LOCK_TARGETS,
                          attr: str = "path",
                          root: str | Path = ".") -> list[Finding]:
    """Run the lock-discipline checks over the shared-store modules.

    Missing targets are skipped silently so the checker can run from any
    working directory subset (CI always passes the repo root)."""
    out: list[Finding] = []
    for p in paths:
        full = Path(root) / p
        if not full.is_file():
            continue
        out.extend(check_lock_source(full.read_text(encoding="utf-8"),
                                     str(full), attr=attr))
    return out
