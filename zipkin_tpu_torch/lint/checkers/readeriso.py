"""ZT13 — reader isolation at full interprocedural depth.

Scale-out read serving (``serving/``) answers queries from processes
that map the published state read-only: there a reader that acquires
the aggregator lock doesn't just lose the read tail — it deadlocks or
faults, because the lock lives in the writer process. The invariant is
"readers never take the aggregator lock", and it has to hold through
EVERY call chain, not just the ones ZT10 can see inside one module.

Roots are reader entrypoints, program-wide:

- functions marked ``# zt-mirror-served: <reason>`` (ZT10's marker —
  today's lock-free serve surface), and
- functions marked ``# zt-reader-process: <reason>`` — the reader
  processes' entrypoints and the shm segment's reader side. A marker
  without a reason is itself a finding (the ZT00 bar).

From each root the whole-program call graph is walked to
``DEFAULT_DEPTH`` (conservative edges included: an over-approximate
walk may flag a chain the runtime never takes, but it cannot miss one
the resolver can see). In every reached function, cross-module from
the root, these are findings:

- ``with X.lock:`` / ``X.lock.acquire(...)`` — the bare-``.lock``
  spelling is the aggregator lock by repo convention (ZT10's rule 1);
- ``with X.<attr>:`` / ``X.<attr>.acquire(...)`` where ``<attr>`` is
  assigned from ``InstrumentedRLock(...)`` ANYWHERE in the program —
  renaming the lock does not launder the acquire.

Sinks in the ROOT'S OWN module are ZT10's jurisdiction and skipped
here, so one bug yields one rule's finding; ZT13 is precisely the
cross-module depth ZT10 never had.
"""

from __future__ import annotations

import ast
import re
from typing import Set

from zipkin_tpu_torch.lint.core import Checker, register
from zipkin_tpu_torch.lint.checkers.mirrorread import _is_bare_lock_attr, _marker

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

READER_MARKER_RE = re.compile(r"#\s*zt-reader-process\b(?P<rest>.*)$")


def _rlock_attr_names(program) -> Set[str]:
    """Attribute/name bindings assigned from ``InstrumentedRLock(...)``
    anywhere in the program — the aggregator-lock aliases."""
    names: Set[str] = set()
    for module in program.modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            if not (
                isinstance(v, ast.Call)
                and (
                    (isinstance(v.func, ast.Name)
                     and v.func.id == "InstrumentedRLock")
                    or (isinstance(v.func, ast.Attribute)
                        and v.func.attr == "InstrumentedRLock")
                )
            ):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    names.add(tgt.attr)
                elif isinstance(tgt, ast.Name):
                    names.add(tgt.id)
    return names


@register
class ReaderIsolation(Checker):
    rule = "ZT13"
    severity = "error"
    name = "reader-isolation"
    doc = (
        "aggregator-lock / InstrumentedRLock acquires reachable cross-"
        "module from mirror-served or reader-process entrypoints"
    )
    hint = (
        "a reader entrypoint must stay lock-free at every depth: serve "
        "the published snapshot, or move locked work into the publisher"
    )
    whole_program = True

    def check_program(self, program):
        rlock_attrs = _rlock_attr_names(program) | {"lock"}
        roots = []
        for module in program.modules:
            for fn in ast.walk(module.tree):
                if not isinstance(fn, _FUNC_KINDS):
                    continue
                marked = _reader_marker(module, fn)
                if marked is not None:
                    _line, rest = marked
                    if not rest.lstrip().startswith(":") \
                            or not rest.lstrip(": ").strip():
                        yield self.found(
                            module, fn,
                            "zt-reader-process marker without a reason — "
                            "say WHY this entrypoint must stay reader-"
                            "isolated (# zt-reader-process: <reason>)",
                        )
                if marked is None and _marker(module, fn) is None:
                    continue
                qual = program.qual_of(fn)
                if qual is not None:
                    roots.append(qual)
        if not roots:
            return
        reached = program.reach(roots)
        for qual, (root, depth, _pred) in reached.items():
            info = program.functions[qual]
            root_info = program.functions[root]
            if info.module_rel == root_info.module_rel:
                continue  # same-module chains are ZT10's jurisdiction
            module = program.module_for(info.module_rel)
            if module is None:
                continue
            via = program.via_chain(reached, qual)
            yield from self._scan_function(
                module, info.node, root_info, via, rlock_attrs
            )

    def _scan_function(self, module, fn, root_info, via, rlock_attrs):
        where = (
            f"reached from reader entrypoint {root_info.name}() "
            f"[{root_info.module_rel}]{via}"
        )
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if self._is_rlock_attr(item.context_expr, rlock_attrs):
                        yield self.found(
                            module, node,
                            f"aggregator lock held in {fn.name}() — "
                            f"{where}; a reader process cannot take the "
                            "writer's lock",
                        )
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "acquire"
                    and self._is_rlock_attr(f.value, rlock_attrs)
                ):
                    yield self.found(
                        module, node,
                        f"aggregator lock acquired in {fn.name}() — "
                        f"{where}; a reader process cannot take the "
                        "writer's lock",
                    )

    @staticmethod
    def _is_rlock_attr(node: ast.AST, rlock_attrs: Set[str]) -> bool:
        if _is_bare_lock_attr(node):
            return True
        return isinstance(node, ast.Attribute) and node.attr in rlock_attrs


def _reader_marker(module, fn):
    """The zt-reader-process marker on fn's header lines, if any."""
    end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line_no in range(fn.lineno, end):
        m = READER_MARKER_RE.search(module.line_text(line_no))
        if m:
            return line_no, m.group("rest")
    return None
