"""ZT09 — dispatch-core critical sections stay free of per-span loops.

The ingest fan-out tier (tpu/mp_ingest.py) exists because parse/pack is
Python-speed work: N workers each own it, and ONE dispatch core applies
their output to the device. The whole pool's ceiling is therefore the
dispatch core's per-payload cost — which must be O(new vocab entries) +
O(chunks), never O(spans). A per-span Python ``for``/``while``/
comprehension slipping into that section (the historical shape: "just
iterate the record rows to remap them") silently caps N workers at one
interpreter's speed, and no unit test notices because correctness is
unaffected.

Functions opt in by carrying a ``# zt-dispatch-critical: <reason>``
marker comment on their ``def`` header (any header line up to the start
of the body, so multi-line signatures work). Inside a marked function
every loop or comprehension is flagged; loops whose trip count is
provably NOT per-span carry a standard ``zt-lint: disable=ZT09`` pragma
whose justification says what the trip count actually is (per new
string, per chunk, ...) — the pragma audit IS the documentation that
the critical section stayed vectorized.

The marker's audit used to stop at the function boundary: hide the
per-span loop in a helper and call the helper, and ZT09 was blind.
With the call graph the rule is compositional one hop out, cross-
module: a call from a marked function that RESOLVES to an unmarked,
loop-bearing callee is flagged at the CALL SITE. The fix is to mark
the callee (putting its loops under this same audit) or to pragma the
call with the trip-count justification. Hops beyond the first are
covered inductively — marking the callee makes ITS calls audited.
"""

from __future__ import annotations

import ast
import re

from zipkin_tpu_torch.lint.core import Checker, Module, register

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOP_KINDS = (ast.For, ast.AsyncFor, ast.While)
_COMP_KINDS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)

MARKER_RE = re.compile(r"#\s*zt-dispatch-critical\b(?P<rest>.*)$")


def _has_own_loop(fn: ast.AST) -> bool:
    """A loop/comprehension in fn's own body (nested defs excluded —
    they are separate functions with their own edges)."""
    nested = set()
    for n in ast.walk(fn):
        if isinstance(n, _FUNC_KINDS) and n is not fn:
            nested.update(id(x) for x in ast.walk(n))
    return any(
        isinstance(n, _LOOP_KINDS + _COMP_KINDS) and id(n) not in nested
        for n in ast.walk(fn)
    )


def _marker(module: Module, fn: ast.AST):
    """The zt-dispatch-critical marker on fn's header lines, if any.

    The header is everything from the ``def`` line up to (not
    including) the first body statement's line — the marker may trail
    the closing paren of a multi-line signature."""
    end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line_no in range(fn.lineno, end):
        m = MARKER_RE.search(module.line_text(line_no))
        if m:
            return line_no, m.group("rest")
    return None


@register
class DispatchCriticalLoops(Checker):
    rule = "ZT09"
    severity = "error"
    name = "dispatch-critical-loops"
    doc = (
        "Python loops/comprehensions inside functions marked "
        "zt-dispatch-critical (the single-threaded dispatch core of the "
        "ingest fan-out)"
    )
    hint = (
        "vectorize over the batch (numpy LUT / fancy indexing), or if "
        "the trip count is per-chunk/per-new-vocab-entry — not per-span "
        "— justify it with a zt-lint: disable=ZT09 pragma saying so"
    )

    def check(self, module: Module):
        for fn in ast.walk(module.tree):
            if not isinstance(fn, _FUNC_KINDS):
                continue
            marked = _marker(module, fn)
            if marked is None:
                continue
            line_no, rest = marked
            if not rest.lstrip().startswith(":") or not rest.lstrip(": ").strip():
                yield self.found(
                    module, fn,
                    "zt-dispatch-critical marker without a reason — say "
                    "WHY this function is on the dispatch core's critical "
                    "path (# zt-dispatch-critical: <reason>)",
                )
            for node in ast.walk(fn):
                if isinstance(node, _LOOP_KINDS):
                    shape = "loop"
                elif isinstance(node, _COMP_KINDS):
                    shape = "comprehension"
                else:
                    continue
                # anchor at the enclosing STATEMENT: a comprehension's
                # own line is mid-expression, where no pragma can sit —
                # the suppression audit lives on the statement line
                anchor = node
                while anchor is not None and not isinstance(anchor, ast.stmt):
                    anchor = module.parents.get(anchor)
                yield self.found(
                    module, anchor or node,
                    f"Python {shape} inside dispatch-critical "
                    f"{fn.name}() — a per-span trip count here caps "
                    "every parse worker at one interpreter's speed",
                )
            yield from self._check_callees(module, fn)

    def _check_callees(self, module: Module, fn: ast.AST):
        """Compositional hop: calls resolving to unmarked loop-bearing
        functions — the hidden-helper-loop shape."""
        graph = self.graph(module)
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            for qual, _resolved in graph.callees_of_call(call):
                info = graph.functions.get(qual)
                if info is None or "<locals>" in qual:
                    continue  # nested defs are inside the marked body
                callee_mod = graph.module_for(info.module_rel) or module
                if _marker(callee_mod, info.node) is not None:
                    continue  # marked callee: its loops carry the audit
                if not _has_own_loop(info.node):
                    continue
                # one finding per call site even when the conservative
                # fallback offers several loop-bearing candidates
                yield self.found(
                    module, call,
                    f"dispatch-critical {fn.name}() calls "
                    f"{info.name}() [{info.module_rel}], which contains "
                    "a Python loop but is not marked zt-dispatch-"
                    "critical — the helper's trip count is unaudited",
                    hint=(
                        "mark the callee zt-dispatch-critical (its "
                        "loops then need per-trip-count justification) "
                        "or pragma this call with the bound"
                    ),
                )
                break
