"""ZT05 — in-place state programs: the old binding read after the call.

The reference's state programs donate their input buffers
(``donate_argnums``), so a read of the donated name after the call
raises on deleted memory. The port's counterpart is a program that
updates its state argument IN PLACE and returns ``state._replace(...)``
(the ingest step's histogram, register, ring and digest scatters; the
flush and the rollup; the HLL kernel's register files): the old binding
still answers, quietly, with the NEW values. The SAFE idiom is the
reference's — ``state = step(state, batch)``: the argument's name is
rebound to the result in the same statement, so nothing reads the old
binding afterwards.

Programs opt in with a marker naming the argument they update:

- ``# zt-in-place: <param> — reason`` on a ``def`` header (any header
  line, as ZT09's marker) names one of its parameters; calls that the
  call graph resolves to the def, or a same-module bare name, are the
  in-place calls, and the argument is found by position or keyword;
- the same marker on an assignment (its first line, or the comment
  lines right above it) marks a binding that holds programs — a name,
  ``self.<attr>``, or a table of them called as ``table[key](...)``
  (the aggregator's step table); the named argument is then the
  programs' first.

At each in-place call the argument expression (a name or ``self``
attribute chain) is captured; if the call's result is NOT assigned back
to that same expression, any later read of it in the same function is
a finding. A marker without a reason is a finding too.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from zipkin_tpu_torch.lint.core import Checker, Module, register

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

MARKER_RE = re.compile(r"#\s*zt-in-place\b(?P<rest>.*)$")
_PARAM_RE = re.compile(r"^\s*:\s*(?P<param>[A-Za-z_]\w*)(?P<reason>.*)$")


def _parse(rest: str) -> Tuple[Optional[str], str]:
    """(param, reason) of a marker's tail; param None when unparsable."""
    m = _PARAM_RE.match(rest)
    if not m:
        return None, ""
    return m.group("param"), m.group("reason").strip(" \t-—:(").rstrip(")")


def def_marker(module: Module, fn: ast.AST):
    """(line, param, reason) of the zt-in-place marker on fn's signature
    lines (a comment line before the body's first statement belongs to
    the body: it may mark a binding there)."""
    end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line_no in range(fn.lineno, end):
        text = module.line_text(line_no)
        if line_no > fn.lineno and text.startswith("#"):
            break
        m = MARKER_RE.search(text)
        if m:
            return (line_no,) + _parse(m.group("rest"))
    return None


def _binding_marker(module: Module, stmt: ast.AST):
    """(line, param, reason) of a marker on an assignment's first line or
    in the comment lines right above it."""
    m = MARKER_RE.search(module.line_text(stmt.lineno))
    if m:
        return (stmt.lineno,) + _parse(m.group("rest"))
    line_no = stmt.lineno - 1
    while line_no >= 1:
        text = module.line_text(line_no)
        if not text.startswith("#"):
            break
        m = MARKER_RE.search(text)
        if m:
            return (line_no,) + _parse(m.group("rest"))
        line_no -= 1
    return None


def _expr_key(node: ast.AST):
    """A stable identity for 'the same expression': Name or self.attr
    chains only — anything fancier can't be tracked reliably."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        inner = _expr_key(node.value)
        return f"{inner}.{node.attr}" if inner else None
    return None


def _callee_key(call: ast.Call):
    """The binding a call goes through: ``f(...)``, ``self.f(...)``,
    ``table[k](...)`` and ``self.table[k](...)`` key on f / table."""
    f = call.func
    if isinstance(f, ast.Subscript):
        f = f.value
    return _expr_key(f)


def _param_position(fn: ast.AST, param: str, bound_method: bool):
    """The positional index of ``param`` at a call site (``self``/``cls``
    dropped for a bound-method call), or None if keyword-only."""
    names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if bound_method and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names.index(param) if param in names else None


@register
class InPlaceMisuse(Checker):
    rule = "ZT05"
    severity = "error"
    name = "in-place-misuse"
    doc = "an in-place program's argument read after the call"
    hint = (
        "rebind the result to the argument in the same statement "
        "(state = step(state, ...)); the old binding sees the new values"
    )

    @staticmethod
    def _program_marks(graph):
        """Every def marker of the run's program, parsed once per graph
        (kept on the graph): (qual -> (def, param), [(module, def,
        well-formed?)])."""
        marks = getattr(graph, "_in_place_marks", None)
        if marks is None:
            marked: Dict[str, Tuple[ast.AST, str]] = {}
            seen: List[Tuple[Module, ast.AST, bool]] = []
            for program_module in graph.modules:
                if "zt-in-place" not in program_module.source:
                    continue
                for fn in ast.walk(program_module.tree):
                    if not isinstance(fn, _FUNC_KINDS):
                        continue
                    hit = def_marker(program_module, fn)
                    if hit is None:
                        continue
                    _line, param, reason = hit
                    ok = bool(param and reason) and (
                        _param_position(fn, param, False) is not None
                        or param in {a.arg for a in fn.args.kwonlyargs}
                    )
                    seen.append((program_module, fn, ok))
                    qual = graph.qual_of(fn)
                    if ok and qual is not None:
                        marked[qual] = (fn, param)
            marks = graph._in_place_marks = (marked, seen)
        return marks

    def check(self, module: Module):
        graph = self.graph(module)
        marked_defs, seen = self._program_marks(graph)
        local_defs: Dict[str, Tuple[ast.AST, str]] = {}    # bare -> (def, param)
        for program_module, fn, ok in seen:
            if program_module is not module:
                continue
            if not ok:
                yield self.found(
                    module, fn,
                    "zt-in-place marker must name a parameter of "
                    f"{fn.name}() and give a reason "
                    "(# zt-in-place: <param> — <reason>)",
                )
                continue
            local_defs.setdefault(fn.name, marked_defs[graph.qual_of(fn)])
        bindings: Dict[str, str] = {}  # binding key -> param
        if "zt-in-place" in module.source:
            for stmt in ast.walk(module.tree):
                if not isinstance(stmt, ast.Assign):
                    continue
                hit = _binding_marker(module, stmt)
                if hit is None:
                    continue
                _line, param, reason = hit
                if param is None or not reason:
                    yield self.found(
                        module, stmt,
                        "zt-in-place marker must name the programs' first "
                        "parameter and give a reason "
                        "(# zt-in-place: <param> — <reason>)",
                    )
                    continue
                for t in stmt.targets:
                    key = _expr_key(t)
                    if key is not None:
                        bindings[key] = param
        if not marked_defs and not bindings:
            return
        for fn in ast.walk(module.tree):
            if isinstance(fn, _FUNC_KINDS):
                yield from self._check_scope(
                    module, graph, fn, marked_defs, local_defs, bindings
                )

    def _in_place_arg(self, graph, call, marked_defs, local_defs, bindings):
        """The argument expression an in-place call updates, or None."""
        key = _callee_key(call)
        if key in bindings and (call.args or call.keywords):
            return call.args[0] if call.args else None
        target = None
        for qual, _resolved in graph.callees_of_call(call):
            if qual in marked_defs:
                target = marked_defs[qual]
                break
        if target is None and isinstance(call.func, ast.Name):
            target = local_defs.get(call.func.id)
        if target is None:
            return None
        fn, param = target
        for k in call.keywords:
            if k.arg == param:
                return k.value
        bound = isinstance(call.func, ast.Attribute) and _expr_key(
            call.func.value
        ) in ("self", "cls")
        pos = _param_position(fn, param, bound)
        if pos is not None and pos < len(call.args):
            return call.args[pos]
        return None

    def _check_scope(self, module, graph, fn, marked_defs, local_defs,
                     bindings):
        # updated expression keys and the line their old binding went
        # stale on
        dead: Dict[str, int] = {}
        calls: List[Tuple[ast.Call, ast.AST]] = []
        # nested defs and lambdas are scopes of their own: a name there is
        # another binding (nested defs are checked on their own)
        nested = set()
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, _FUNC_KINDS + (ast.Lambda,)):
                nested.update(id(n) for n in ast.walk(node))
        own = [n for n in ast.walk(fn) if id(n) not in nested]
        for node in own:
            if isinstance(node, ast.Call):
                arg = self._in_place_arg(
                    graph, node, marked_defs, local_defs, bindings
                )
                if arg is not None:
                    calls.append((node, arg))
        calls.sort(key=lambda c: (c[0].lineno, c[0].col_offset))
        for call, arg in calls:
            # the NEAREST enclosing statement decides the same-statement
            # rebind (state = step(state, ...) keeps the name live)
            stmt = next(iter(module.enclosing(call, ast.stmt)), None)
            rebound: Set[str] = set()
            if isinstance(stmt, ast.Assign) and stmt.value is call:
                rebound = {
                    k for k in map(_expr_key, stmt.targets) if k is not None
                }
            key = _expr_key(arg)
            if key is not None and key not in rebound:
                dead[key] = call.lineno
        if not dead:
            return
        # uses in source order, so a later rebind ends tracking exactly
        # where it happens (a rebound name is a live binding again)
        uses = []
        for node in own:
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            key = _expr_key(node)
            if key in dead:
                uses.append((node.lineno, node.col_offset, key, node))
        for _, _, key, node in sorted(uses, key=lambda u: (u[0], u[1])):
            if key not in dead or node.lineno <= dead[key]:
                continue
            if isinstance(node.ctx, ast.Store):
                dead.pop(key, None)
                continue
            if not isinstance(node.ctx, ast.Load):
                continue
            yield self.found(
                module,
                node,
                f"{key} was updated in place on line {dead[key]} and read "
                "here — the old binding already holds the new values",
            )
            dead.pop(key, None)  # one finding per updated expr
