"""ZT10 — mirror-served reads stay off the aggregator lock.

The epoch-published read mirror (``tpu/mirror.py``) takes the query
path off the aggregator lock: it serves immutable snapshots behind a
seqlock generation stamp, and the read tail's whole claim rests on the
serve path never blocking. The regression shape
this rule fences is quiet and plausible-looking: someone "just adds" a
live-counter touch or a cache probe to the serve path, the call chain
re-enters ``_cached_read`` or an aggregator read method, and suddenly 8
reader threads queue on the lock again — correctness unaffected, the
SLO gone, and no unit test notices.

Functions opt in with a ``# zt-mirror-served: <reason>`` marker on the
``def`` header (multi-line signatures work, same mechanics as ZT09's
dispatch-critical marker). From each marked function the rule walks the
whole-program call graph restricted to the module (qualified-name
resolution: bare names bind lexically, ``self.m()`` binds to the
enclosing class, unknown attribute receivers fall back conservatively
to same-module defs — over-approximate rather than miss a helper) and
flags, anywhere reachable:

1. taking the aggregator lock itself — ``with X.lock:`` or
   ``X.lock.acquire(...)`` where the attribute is spelled exactly
   ``lock``. The repo's naming convention is load-bearing here: the
   InstrumentedRLock on the aggregator is the ONE lock published as a
   bare ``.lock`` attribute; private coordination locks are ``_lock``,
   ``_demand_lock``, ``_snapshot_lock``, ... and stay legal (the
   mirror's demand registry uses one).
2. calls into known lock-taking entrypoints (``LOCK_TAKERS``): the
   store's version-keyed memoizer and the aggregator read methods that
   acquire internally. These are correct answers on the WRONG path —
   each one re-serializes the reader behind ingest holds.

A marker without a reason is itself a finding (the ZT00 bar: opt-in
claims are reviewable statements, not magic words).

This rule stays same-module on purpose: chains that LEAVE the module
are ZT13's jurisdiction (reader isolation at full interprocedural
depth), so one bug yields one rule's finding.
"""

from __future__ import annotations

import ast
import re

from zipkin_tpu_torch.lint.core import Checker, Module, register

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

MARKER_RE = re.compile(r"#\s*zt-mirror-served\b(?P<rest>.*)$")

# entrypoints known to acquire the aggregator lock (directly or one hop
# down): the store's memoizer + the aggregator's locked read surface.
# Conservative by NAME — a same-named method on another object is still
# a finding, because on a mirror-served path there should be no object
# answering these names at all.
LOCK_TAKERS = frozenset({
    "_cached_read",
    "dependency_edges",
    "dependency_matrices",
    "quantiles",
    "cardinalities",
    "sketch_overview",
    "merged_digest",
    "merged_sketches",
    "window_fully_rolled",
    "state_clone",
    "sync_pend_lanes",
    # time tier: the packed device pull of the unsealed
    # current bucket acquires the aggregator lock (flush-then-read),
    # and TimeTier.window() reaches it for any range past
    # sealed_through — windowed serves must come off the published
    # ``ttq:`` WindowAnswer, never recompute the merge per request
    "tt_read",
    "tt_sketches",
})


def _marker(module: Module, fn: ast.AST):
    """The zt-mirror-served marker on fn's header lines, if any."""
    end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line_no in range(fn.lineno, end):
        m = MARKER_RE.search(module.line_text(line_no))
        if m:
            return line_no, m.group("rest")
    return None


def _callee_name(func: ast.AST):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_bare_lock_attr(node: ast.AST) -> bool:
    """True for ``<anything>.lock`` — the aggregator-lock spelling."""
    return isinstance(node, ast.Attribute) and node.attr == "lock"


@register
class MirrorServedLockAcquire(Checker):
    rule = "ZT10"
    severity = "error"
    name = "mirror-served-lock-acquire"
    doc = (
        "aggregator-lock acquisition (direct, or via known lock-taking "
        "helpers) reachable from functions marked zt-mirror-served"
    )
    hint = (
        "a mirror serve must stay lock-free: read the published "
        "snapshot, or move the locked work into the mirror publisher "
        "(one lock hold per epoch, not per query)"
    )

    def check(self, module: Module):
        roots = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, _FUNC_KINDS):
                continue
            marked = _marker(module, fn)
            if marked is None:
                continue
            _line, rest = marked
            if not rest.lstrip().startswith(":") or not rest.lstrip(": ").strip():
                yield self.found(
                    module, fn,
                    "zt-mirror-served marker without a reason — say WHY "
                    "this function serves lock-free "
                    "(# zt-mirror-served: <reason>)",
                )
            roots.append(fn)
        if not roots:
            return
        # qualified-name reachability within the module (cross-module
        # chains are ZT13's); conservative fallback edges included —
        # over-approximate rather than miss a helper
        graph = self.graph(module)
        root_quals = [q for q in map(graph.qual_of, roots) if q]
        reached = graph.reach(root_quals, same_module=True)
        seen = set()  # one scan per function even when several roots reach it
        for qual, (root, _depth, _pred) in reached.items():
            info = graph.functions[qual]
            if info.module_rel != module.rel or id(info.node) in seen:
                continue
            seen.add(id(info.node))
            yield from self._scan_function(
                module, info.node, graph.functions[root].name
            )

    def _scan_function(self, module: Module, fn: ast.AST, root: str):
        via = "" if fn.name == root else f" (via {fn.name}())"
        for node in ast.walk(fn):
            if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
                for item in node.items:
                    if _is_bare_lock_attr(item.context_expr):
                        yield self.found(
                            module, node,
                            f"aggregator lock held inside mirror-served "
                            f"{root}(){via} — the serve path re-queues "
                            "readers behind ingest holds",
                        )
            elif isinstance(node, ast.Call):
                name = _callee_name(node.func)
                if (
                    name == "acquire"
                    and isinstance(node.func, ast.Attribute)
                    and _is_bare_lock_attr(node.func.value)
                ):
                    yield self.found(
                        module, node,
                        f"aggregator lock acquired inside mirror-served "
                        f"{root}(){via} — the serve path re-queues "
                        "readers behind ingest holds",
                    )
                elif name in LOCK_TAKERS:
                    yield self.found(
                        module, node,
                        f"lock-taking helper {name}() called from "
                        f"mirror-served {root}(){via} — this re-enters "
                        "the aggregator lock per query; serve the "
                        "published snapshot instead",
                    )
