"""ZT07 — full-ring sorts on the fresh-read path, in torch form.

The link context's O(R log R) rebuild (a four-key sort over every union
lane of the ring) runs at rollup cadence: the sorted union order is
maintained incrementally, and a fresh read may sort only the
since-rollup DELTA segment (``ops/delta_linker.py``). This rule is the
regression fence: any sort-family op — or a call back into the
from-scratch ctx rebuild — reachable from a fresh-read entrypoint
reintroduces the full-ring cost.

Mechanics: functions named in ``FRESH_READ_ENTRYPOINTS`` — wherever
they live — seed a walk over the WHOLE-PROGRAM call graph (qualified-
name resolution; conservative fallback edges descend into same-module
defs and uniquely-named imported methods, over-approximating rather
than missing a helper). Inside reachable functions, in whatever module
the walk lands, two shapes are flagged:

1. sort-family calls: ``torch.sort`` / ``.sort()``, ``torch.argsort`` /
   ``.argsort()``, ``torch.msort``, ``torch.unique`` / ``.unique()``, and
   the port's ``u32.lexsort`` (two chained stable sorts).
   ``torch.cumsum`` is deliberately NOT in the set: prefix sums are the
   delta formulation's own workhorse (compaction counting, run-id
   assignment) and are O(n) — the hazard fenced here is the
   O(n log n) comparison sort.
2. calls to the from-scratch rebuilds ``link_context`` /
   ``resolve_parents`` (ops/linker.py): correct answers, wrong tier —
   they are the rollup/oracle path.

The ONE legitimate sort on the fresh path — the delta-segment sort in
``delta_linker._resolve_core`` — carries a ZT07 pragma whose reason
states the bound (2·Δ delta-segment lanes); ZT00 keeps that claim
reviewable.

A second fenced surface has the same failure shape at another tier:
windowed sketch queries (``[lookback, endTs]`` on the quantile,
cardinality and dependency routes) answer by merging sealed time-bucket
segments (``tpu/timetier.py``). The tempting regression is a fallback
that answers an uncovered window by rescanning the span archive
(``candidate_trace_ids`` / ``_disk_query`` — O(archive) wall per query);
uncovered epochs are reported as coverage gaps instead. That walk is
UNGATED on torch imports: the windowed routing layer is pure host code.
(The sort fence gates on the ROOT's module importing torch — a
torch-free entrypoint module cannot seed a device sort.)
"""

from __future__ import annotations

import ast

from zipkin_tpu_torch.lint.core import Checker, Module, register
from zipkin_tpu_torch.lint.taint import _root_name

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

# the query-path surface: functions that run (or build the program for)
# a FRESH read. The graph follows imports, so seeding each module's own
# entrypoint is belt-and-braces; the names stay because each IS an
# entrypoint of its tier.
FRESH_READ_ENTRYPOINTS = {
    "edges_fresh",          # parallel/aggregator.py: fused ctx+edges program
    "fresh_link_context",   # tpu/ingest.py: delta-read entrypoint
    "delta_link_context",   # ops/delta_linker.py: resolve + chase + rules
    "delta_resolve",        # ops/delta_linker.py: resolve only
}

# O(n log n) sorts; torch.cumsum is deliberately absent (see module
# docstring). ``lexsort`` is the port's u32.lexsort.
SORT_ATTRS = {"sort", "argsort", "msort", "unique", "lexsort"}

# the from-scratch oracle surface (ops/linker.py)
FULL_REBUILDS = {"link_context", "resolve_parents"}

# windowed sketch-tier entrypoints (tpu/store.py): queries
# carrying a [lookback, endTs] range answer from merged time-bucket
# segments
WINDOWED_ENTRYPOINTS = {
    "latency_quantiles",
    "trace_cardinalities",
    "_get_dependencies",
    "_tt_window",
}

# the full-archive scan surface (tpu/store.py → tpu/archive.py):
# correct for trace retrieval, catastrophic as a windowed-sketch
# fallback — O(archive) wall per query
ARCHIVE_SCANNERS = {"candidate_trace_ids", "_disk_query"}


def _callee_name(func: ast.AST):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


@register
class FreshReadRingSort(Checker):
    rule = "ZT07"
    severity = "error"
    name = "fresh-read-ring-sort"
    doc = (
        "sort ops or from-scratch ctx rebuilds reachable from "
        "fresh-read entrypoints"
    )
    hint = (
        "fresh reads may only sort the since-rollup delta segment "
        "(ops/delta_linker.py); move full-ring work to rollup cadence, "
        "or suppress with a reason stating the delta-size bound"
    )
    whole_program = True

    def check_program(self, program):
        fresh_roots, windowed_roots = [], []
        for module in program.modules:
            torch_gated = "torch" in module.imported_roots
            for fn in ast.walk(module.tree):
                if not isinstance(fn, _FUNC_KINDS):
                    continue
                qual = program.qual_of(fn)
                if qual is None:
                    continue
                # sort fence gates on the ROOT's module importing torch:
                # the hazard is a device sort, which a torch-free
                # entrypoint module cannot seed
                if fn.name in FRESH_READ_ENTRYPOINTS and torch_gated:
                    fresh_roots.append(qual)
                if fn.name in WINDOWED_ENTRYPOINTS:
                    windowed_roots.append(qual)
        for qual, (root, _d, _p) in program.reach(fresh_roots).items():
            info = program.functions[qual]
            module = program.module_for(info.module_rel)
            if module is not None:
                yield from self._scan_function(
                    module, info.node, program.functions[root].name
                )
        for qual, (root, _d, _p) in program.reach(windowed_roots).items():
            info = program.functions[qual]
            module = program.module_for(info.module_rel)
            if module is not None:
                yield from self._scan_windowed(
                    module, info.node, program.functions[root].name
                )

    def _scan_function(self, module: Module, fn: ast.AST, root: str):
        if fn.name in SORT_ATTRS:
            # a sort primitive's own body (u32.lexsort): every call into
            # it is the finding, at the caller
            return
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_name(node.func)
            if name in SORT_ATTRS and (
                isinstance(node.func, ast.Attribute) or name == "lexsort"
            ):
                where = "" if fn.name == root else f" (via {fn.name}())"
                spelled = (
                    f"{_root_name(node.func)}.{name}"
                    if isinstance(node.func, ast.Attribute) else name
                )
                yield self.found(
                    module,
                    node,
                    f"{spelled} reachable from fresh-read entrypoint "
                    f"{root}(){where} — fresh reads must not pay "
                    "full-ring sort cost",
                )
            elif name in FULL_REBUILDS and fn.name not in FULL_REBUILDS:
                where = "" if fn.name == root else f" (via {fn.name}())"
                yield self.found(
                    module,
                    node,
                    f"from-scratch rebuild {name}() called from "
                    f"fresh-read entrypoint {root}(){where} — use the "
                    "incremental delta formulation",
                )

    def _scan_windowed(self, module: Module, fn: ast.AST, root: str):
        if fn.name in ARCHIVE_SCANNERS:
            # the scanners themselves (and their internals) are the
            # trace-retrieval path — only CALLS INTO them from the
            # windowed surface are the violation
            return
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_name(node.func)
            if name in ARCHIVE_SCANNERS:
                where = "" if fn.name == root else f" (via {fn.name}())"
                yield self.found(
                    module,
                    node,
                    f"archive scanner {name}() reachable from windowed "
                    f"entrypoint {root}(){where} — windowed queries must "
                    "merge sealed time-bucket segments (coverage gaps "
                    "are reported, not backfilled by archive rescans)",
                )
