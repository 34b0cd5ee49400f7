"""ZT12 — durability-commit chokepoints in the persistence modules.

A file a restore can read must be COMMITTED, not merely written: bytes
to a tmp name, ``fsync`` the file (bytes durable), ``os.replace`` onto
the real name (visibility atomic), ``fsync`` the directory (the rename
itself durable). Skip any link and there is a crash window where
recovery reads a file that is missing, empty, or half-written — the
exact class of bug the crashpoint harness exists to catch, except a
NEW write path only gets crashpoint coverage if someone remembers to
add it. This rule makes forgetting loud, in the four registered
persistence modules (``wal.py``, ``snapshot.py``, ``timetier.py``,
``archive.py``):

- **``os.replace`` / ``os.rename`` without a preceding fsync**: the
  destination name can point at unsynced bytes — after a crash the
  rename survives but the contents don't.
- **``os.replace`` / ``os.rename`` without a following directory
  fsync**: the rename itself can vanish — recovery sees the OLD file.
- **a write-mode ``open()`` with no fsync anywhere on its path**: the
  function, its resolved callees, and its in-graph callers (the
  open-here-fsync-in-caller split ``Wal._file_for``/``append`` uses)
  are all searched via the call graph before flagging.

Exempt by construction: tmp-named targets (a ``*.tmp`` path or a name
binding containing ``tmp`` — those bytes are committed by the rename
that follows, which is checked instead) and ``os.fdopen`` inside a
function that called ``tempfile.mkstemp``. Deliberate exceptions —
quarantine renames that move ALREADY-corrupt bytes aside, append-mode
live files whose durability contract is the WAL's — carry
pragma-with-reason at the site, so every exception is a reviewed
sentence, not an unstated assumption.
"""

from __future__ import annotations

import ast
from typing import Optional, Set

from zipkin_tpu_torch.lint.core import Checker, Module, register

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

MODULES = (
    "zipkin_tpu_torch/tpu/wal.py",
    "zipkin_tpu_torch/tpu/snapshot.py",
    "zipkin_tpu_torch/tpu/timetier.py",
    "zipkin_tpu_torch/tpu/archive.py",
)

_RENAMES = {"replace", "rename"}
_REACH_DEPTH = 3  # helper chains are shallow; bounds the fsync search


def _callee_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_fsync_name(name: Optional[str]) -> bool:
    return bool(name) and ("fsync" in name or name == "fdatasync")


def _write_mode(call: ast.Call) -> bool:
    """open()/os.fdopen() with a literal w/a/x mode."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
        return False
    return mode.value.replace("b", "").replace("+", "") in {"w", "a", "x"}


def _tmp_target(node: ast.AST) -> bool:
    """Heuristic tmp-ness of a path expression: any name binding with
    ``tmp`` in it, or a string constant mentioning ``tmp``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "tmp" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "tmp" in n.attr.lower():
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "tmp" in n.value.lower():
            return True
    return False


@register
class DurabilityCommit(Checker):
    rule = "ZT12"
    severity = "error"
    name = "durability-commit"
    doc = (
        "persistence modules: restore-readable files flow through "
        "tmp+fsync+rename+dir-fsync; bare writes/renames are findings"
    )
    hint = (
        "write to a tmp name, fsync the file, os.replace onto the real "
        "name, then fsync the directory (see snapshot.py's commit chain)"
    )

    def check(self, module: Module):
        if not any(module.rel.endswith(m) for m in MODULES):
            return
        for fn in ast.walk(module.tree):
            if not isinstance(fn, _FUNC_KINDS):
                continue
            yield from self._check_function(module, fn)

    # -- per-function ------------------------------------------------------

    def _check_function(self, module: Module, fn: ast.AST):
        nested: Set[int] = set()
        for n in ast.walk(fn):
            if isinstance(n, _FUNC_KINDS) and n is not fn:
                nested.update(id(x) for x in ast.walk(n))
        calls = [
            n for n in ast.walk(fn)
            if isinstance(n, ast.Call) and id(n) not in nested
        ]
        fsync_lines = sorted(
            c.lineno for c in calls if self._reaches_fsync(c)
        )
        has_mkstemp = any(
            _callee_name(c.func) in {"mkstemp", "NamedTemporaryFile"}
            for c in calls
        )
        for call in calls:
            name = _callee_name(call.func)
            if name in _RENAMES and isinstance(call.func, ast.Attribute):
                if not any(line < call.lineno for line in fsync_lines):
                    yield self.found(
                        module, call,
                        f"os.{name} in {fn.name}() without a preceding "
                        "fsync — after a crash the new name can point at "
                        "unsynced (lost) bytes",
                    )
                if not any(line > call.lineno for line in fsync_lines):
                    yield self.found(
                        module, call,
                        f"os.{name} in {fn.name}() without a following "
                        "directory fsync — the rename itself is not "
                        "durable and recovery may see the old file",
                    )
            elif name == "open" and isinstance(call.func, ast.Name):
                if not _write_mode(call) or not call.args:
                    continue
                if _tmp_target(call.args[0]):
                    continue  # committed by the rename, checked above
                if fsync_lines or self._caller_fsyncs(module, fn):
                    continue
                yield self.found(
                    module, call,
                    f"write-mode open in {fn.name}() with no fsync on "
                    "any path through it (function, callees, callers) — "
                    "a restore can read this file's unsynced bytes",
                )
            elif name == "fdopen" and not has_mkstemp and _write_mode(call):
                if not fsync_lines and not self._caller_fsyncs(module, fn):
                    yield self.found(
                        module, call,
                        f"write-mode fdopen in {fn.name}() outside the "
                        "mkstemp+fsync+rename commit idiom",
                    )

    # -- graph-backed fsync search ----------------------------------------

    def _reaches_fsync(self, call: ast.Call) -> bool:
        """The call IS an fsync, or resolves to a function that reaches
        one within a short chain (``self._commit()`` helpers)."""
        if _is_fsync_name(_callee_name(call.func)):
            return True
        if self.program is None:
            return False
        return any(
            self._fn_reaches_fsync(qual, _REACH_DEPTH)
            for qual, _resolved in self.program.callees_of_call(call)
        )

    def _fn_reaches_fsync(self, qual: str, depth: int) -> bool:
        info = self.program.functions.get(qual)
        if info is None or depth < 0:
            return False
        for n in ast.walk(info.node):
            if isinstance(n, ast.Call) and _is_fsync_name(
                _callee_name(n.func)
            ):
                return True
        if depth == 0:
            return False
        return any(
            resolved and self._fn_reaches_fsync(callee, depth - 1)
            for callee, resolved in self.program.edges.get(qual, ())
        )

    def _caller_fsyncs(self, module: Module, fn: ast.AST) -> bool:
        """The split idiom: this function opens, its caller fsyncs
        (``Wal._file_for`` / ``Wal.append``). Honest only when EVERY
        in-graph caller fsyncs — one caller skipping it is the bug."""
        if self.program is None:
            return False
        qual = self.program.qual_of(fn)
        if qual is None:
            return False
        callers = self.program.callers_of(qual)
        if not callers:
            return False
        return all(
            self._fn_reaches_fsync(c, _REACH_DEPTH) for c in callers
        )
