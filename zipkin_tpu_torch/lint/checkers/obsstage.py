"""ZT08 — flight-recorder stage discipline.

The obs tier (``zipkin_tpu_torch/obs``) is host-side instrumentation with
a CLOSED stage taxonomy (``obs.stages.STAGES``): dashboards, budgets and
the /statusz schema key off the fixed name set, and the recorder indexes
histograms by ``STAGE_INDEX`` — an unknown name is a hot-path KeyError.
Two shapes are flagged:

1. ``record()`` reachable from code that runs its Python once and
   replays later. In the port that is:

   - a function called inside a capture region (the region itself
     included): a ``with torch.cuda.graph(...)`` block, or the statements
     between ``<graph>.capture_begin(...)`` and ``<graph>.capture_end()``
     in one block (``tpu/graphs.py:StepGraphs.capture``); capture records
     the kernels, and every replay runs them without the Python;
   - a step program, which that capture calls through a ``program``
     parameter the call graph cannot resolve: every def nested in a def
     whose signature lines carry a ``# zt-captured`` marker
     (``parallel/aggregator.py:shard_program``, whose closures are the step
     variants ``StepGraphs`` captures);
   - a function passed to ``torch.cuda.make_graphed_callables``;
   - a function passed to ``torch.compile`` or decorated with it: the
     compiled code may skip the Python a guard already proved.

   ``obs.record`` is Python host code (thread-local lists, a seqlock
   counter): in such a region it runs once at capture — one bogus
   sample — and never again. Traced defs are those above plus everything
   they reach through the whole-program call graph's RESOLVED edges
   (lexical/self/import resolution) at cross-module depth. Fallback
   name-keyed edges are excluded: a traced ``x.m()`` on an unknown
   receiver must not smear "traced" onto every same-named host method.
   The port's ingest step is such a graph (one per step variant), so this
   half holds everything ``ingest_step``, ``flush_digest`` and
   ``rollup_step`` reach.
2. A ``record()`` stage argument that is not a string literal from the
   taxonomy. Literal-only keeps every stage name greppable and lets this
   rule verify membership statically. To add a stage, extend
   ``obs/stages.py`` (name + budget) and this rule learns it.

Recognized record shapes: ``obs.record(...)``, ``RECORDER.record(...)``,
``obs.RECORDER.record(...)``, and a bare ``record(...)`` when the module
imports it ``from zipkin_tpu_torch.obs import record``. ``record_relayed``
— the no-selfspan variant the fan-out dispatcher uses for worker-measured
stages — is held to the same discipline.

The windowed-telemetry, device-observatory, accuracy, critical-path and
query-trace hooks are host instrumentation too (ring state under locks,
``perf_counter`` walls, CUDA-event pairs): traced-reachability flags them
alongside ``record`` (roots ``WINDOWS``/``OBSERVATORY``/``obs_device``/
``SHADOW``/``ACCURACY``/``critpath``/``querytrace``, plus bare imports
from those modules).
"""

from __future__ import annotations

import ast
import re

from zipkin_tpu_torch.lint.core import Checker, Module, register
from zipkin_tpu_torch.lint.taint import _attr_chain, _root_name
from zipkin_tpu_torch.obs.stages import STAGES

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

_RECORD_ATTRS = {"record", "record_relayed"}
_RECORD_ROOTS = {"obs", "RECORDER"}
# windows/device/shadow hooks: host-only for the same reason record is;
# flagged by the traced-reach pass but exempt from stage-arg validation
# (they take no stage). The accuracy-observatory hooks: offer_* are
# bounded-deque appends and drain/rollup mutate shadow state under locks
# — a captured region would keep one capture-time batch forever.
_HOOK_ATTRS = {
    "tick", "tick_if_due", "observe", "wrap",
    "offer_cols", "offer_fused", "offer_spans", "drain",
    "rollup", "maybe_rollup",
    # critical-path tracer: ledger writes are seqlocked shared-memory
    # mutation + perf_counter reads, and the stitcher folds under a lock
    # — all host-only. A captured region would stamp one interval forever.
    "stamp", "stamp_active", "alloc", "ack", "abandon", "release",
    "stitch", "calibrate", "set_active", "set_active_group",
    "clear_active",
    # query-plane observatory: trace arming is thread-local state, the
    # instrumented-lock wrapper measures perf_counter waits, and the
    # stitcher folds under a lock — all host-only.
    "begin", "finish", "relabel", "lock_label",
}
_HOOK_ROOTS = {
    "obs", "WINDOWS", "OBSERVATORY", "obs_device", "SHADOW", "ACCURACY",
    "critpath", "_critpath", "CRITPATH",
    "querytrace", "_querytrace", "QUERYTRACE",
}
_HOOK_MODULES = {
    "zipkin_tpu_torch.obs.windows", "zipkin_tpu_torch.obs.device",
    "zipkin_tpu_torch.obs.shadow", "zipkin_tpu_torch.obs.accuracy",
    "zipkin_tpu_torch.obs.critpath", "zipkin_tpu_torch.obs.querytrace",
}
# callables whose Python runs once and replays: compiled or graphed
_TRACE_CALLS = (["torch", "compile"], ["make_graphed_callables"],
                ["torch", "cuda", "make_graphed_callables"])
# on a def's signature lines: its nested defs are programs a CUDA graph
# captures
_CAPTURED_RE = re.compile(r"#\s*zt-captured\b")


def _is_trace_call(node: ast.AST) -> bool:
    """torch.compile(...), make_graphed_callables(...), or a partial
    over one."""
    if not isinstance(node, ast.Call):
        return False
    path = _attr_chain(node.func)
    if path is not None and (path in _TRACE_CALLS or path[-1] ==
                             "make_graphed_callables"):
        return True
    f = node.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr == "partial"
        and node.args
        and _is_trace_call(ast.Call(func=node.args[0], args=[], keywords=[]))
    ):
        return True
    return False


def _marked_captured(module: Module, fn: ast.AST) -> bool:
    """Whether a ``# zt-captured`` marker sits on ``fn``'s signature lines
    (a comment line before the body's first statement belongs to the
    body)."""
    end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line_no in range(fn.lineno, end):
        text = module.line_text(line_no)
        if line_no > fn.lineno and text.startswith("#"):
            break
        if _CAPTURED_RE.search(text):
            return True
    return False


def _graph_call(stmt: ast.stmt, method: str) -> bool:
    """``<graph>.capture_begin(...)`` / ``<graph>.capture_end()`` as a
    statement."""
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == method)


def _capture_regions(tree: ast.AST):
    """(anchor node, statements) of every capture region: the body of a
    ``with torch.cuda.graph(...)`` block, and the statements from a
    ``capture_begin`` statement up to the ``capture_end`` statement of
    the same block (or the block's end)."""
    for node in ast.walk(tree):
        if _is_capture_block(node):
            yield node, node.body
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, stmt in enumerate(stmts):
                if not _graph_call(stmt, "capture_begin"):
                    continue
                region = []
                for later in stmts[i + 1:]:
                    if _graph_call(later, "capture_end"):
                        break
                    region.append(later)
                yield stmt, region


def _is_capture_block(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` — a CUDA-graph capture region."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call):
            path = _attr_chain(e.func)
            if path and path[-1] == "graph" and (
                "cuda" in path or len(path) == 1
            ):
                return True
    return False


@register
class ObsStageDiscipline(Checker):
    rule = "ZT08"
    severity = "error"
    name = "obs-stage-discipline"
    doc = (
        "obs.record inside captured/compiled code; stage args outside "
        "the closed taxonomy"
    )
    hint = (
        "record stages from host code only, with a string literal from "
        "obs.stages.STAGES; to add a stage extend obs/stages.py"
    )

    whole_program = True

    def check_program(self, program):
        aliases = {}  # module rel -> (record aliases, hook aliases)
        traced_roots = []
        for module in program.modules:
            if "zipkin_tpu_torch" not in module.imported_roots:
                continue
            bare, bare_hooks = self._bare_aliases(module)
            aliases[module.rel] = (bare, bare_hooks)
            records = [
                node
                for node in ast.walk(module.tree)
                if self._is_record_call(node, bare)
            ]
            yield from self._check_stage_args(module, records)
            if "torch" in module.imported_roots:
                traced_roots.extend(
                    q for q in map(
                        program.qual_of, self._traced_defs(module)
                    ) if q
                )
                for anchor, region in _capture_regions(module.tree):
                    # the capture region runs once, and every function it
                    # calls is a traced root
                    fn = next(iter(module.enclosing(anchor, _FUNC_KINDS)),
                              None)
                    label = f"{fn.name}()'s capture" if fn else "capture"
                    for stmt in region:
                        yield from self._scan_traced(
                            module, stmt, label, bare, bare_hooks
                        )
                        for call in ast.walk(stmt):
                            if isinstance(call, ast.Call):
                                traced_roots.extend(
                                    q for q, resolved in
                                    program.callees_of_call(call)
                                    if resolved
                                )
        if not traced_roots:
            return
        # traced-reach rides RESOLVED edges only (module docstring)
        reached = program.reach(traced_roots, resolved_only=True)
        for qual, (root, _d, _p) in reached.items():
            info = program.functions[qual]
            module = program.module_for(info.module_rel)
            if module is None:
                continue
            if module.rel not in aliases:
                aliases[module.rel] = self._bare_aliases(module)
            bare, bare_hooks = aliases[module.rel]
            yield from self._scan_traced(
                module, info.node, program.functions[root].name,
                bare, bare_hooks,
            )

    # -- record/hook call recognition --------------------------------------

    def _bare_aliases(self, module: Module):
        """(record aliases, hook aliases) pulled in by bare imports."""
        records, hooks = set(), set()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.module == "zipkin_tpu_torch.obs":
                for a in node.names:
                    if a.name in _RECORD_ATTRS:
                        records.add(a.asname or a.name)
            elif node.module in _HOOK_MODULES:
                for a in node.names:
                    if a.name in _HOOK_ATTRS:
                        hooks.add(a.asname or a.name)
        return records, hooks

    def _is_record_call(self, node: ast.AST, bare: set) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _RECORD_ATTRS:
            return _root_name(f) in _RECORD_ROOTS
        return isinstance(f, ast.Name) and f.id in bare

    def _is_hook_call(self, node: ast.AST, bare_hooks: set) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _HOOK_ATTRS:
            return _root_name(f) in _HOOK_ROOTS
        return isinstance(f, ast.Name) and f.id in bare_hooks

    # -- shape 2: stage names come from the closed taxonomy ----------------

    def _check_stage_args(self, module: Module, records):
        for call in records:
            arg = call.args[0] if call.args else None
            if arg is None:
                for kw in call.keywords:
                    if kw.arg == "stage":
                        arg = kw.value
            if arg is None:
                yield self.found(module, call, "record() call with no stage")
                continue
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                yield self.found(
                    module,
                    call,
                    "record() stage must be a string literal — dynamic "
                    "names dodge the taxonomy and the budget table",
                )
                continue
            if arg.value not in STAGES:
                yield self.found(
                    module,
                    call,
                    f"unknown stage {arg.value!r} — not in obs.stages."
                    "STAGES (histograms/budgets/statusz key off the "
                    "closed set)",
                )

    # -- shape 1: no recording inside device-traced code -------------------

    def _traced_defs(self, module: Module):
        """Defs decorated with (or passed by name to) torch.compile /
        make_graphed_callables, and the programs nested in a def marked
        ``# zt-captured``."""
        defs = {}
        for node in ast.walk(module.tree):
            if isinstance(node, _FUNC_KINDS):
                defs.setdefault(node.name, node)
        traced = [
            inner
            for fn in ast.walk(module.tree)
            if isinstance(fn, _FUNC_KINDS) and _marked_captured(module, fn)
            for inner in fn.body if isinstance(inner, _FUNC_KINDS)
        ]
        for fn in defs.values():
            if any(_is_trace_call(d) or _trace_target(d) for d in fn.decorator_list):
                traced.append(fn)
        for node in ast.walk(module.tree):
            if _is_trace_call(node):
                for arg in node.args:
                    elts = arg.elts if isinstance(arg, ast.Tuple) else [arg]
                    for el in elts:
                        tgt = (defs.get(el.id) if isinstance(el, ast.Name)
                               else None)
                        if tgt is not None:
                            traced.append(tgt)
        return traced

    def _scan_traced(self, module, fn, root, bare, bare_hooks):
        name = getattr(fn, "name", None)
        where = "" if name is None or f"{name}()" == root \
            else f" (via {name}())"
        for node in ast.walk(fn):
            if self._is_record_call(node, bare):
                yield self.found(
                    module,
                    node,
                    f"obs.record inside captured/compiled {root}"
                    f"{where} — host-side instrumentation runs once at "
                    "capture, then never again on replay",
                )
            elif self._is_hook_call(node, bare_hooks):
                yield self.found(
                    module,
                    node,
                    f"obs windows/device hook inside captured/compiled "
                    f"{root}{where} — ring/registry mutation is host "
                    "code; a replay skips it and keeps the capture's "
                    "values",
                )


def _trace_target(dec: ast.AST) -> bool:
    """Bare (non-call) decorator: ``@torch.compile``."""
    return _attr_chain(dec) == ["torch", "compile"]
