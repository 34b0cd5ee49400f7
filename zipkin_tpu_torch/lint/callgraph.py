"""Whole-program call graph: qualified-name resolution + bounded reach.

The shared engine every interprocedural rule rides on:

- **Qualified names.** Every def gets a dotted qualname mirroring
  Python's own scoping: ``pkg.mod.func``, ``pkg.mod.Class.method``,
  ``pkg.mod.outer.<locals>.inner``. Two same-named defs can not
  collide, because edges are keyed by qualname, not bare name.

- **Resolution, most-precise first.** A bare-name call resolves
  LEXICALLY (enclosing functions' nested defs, then module scope, then
  ``from x import f`` symbols) — exactly Python's rules: a nested def is
  only reachable from the scope that can actually see it. ``self.m()`` /
  ``cls.m()`` resolves against the enclosing class (single-inheritance
  bases included when they live in the program). ``alias.attr(...)``
  chains resolve through the import table (``import a.b.c``,
  ``from a.b import c as d``). Decorated defs resolve like undecorated
  ones — a ``functools.wraps`` wrapper changes the runtime object, not
  the source-level callee.

- **Conservative fallback, bounded.** An attribute call on an unknown
  receiver (``obj.m()``, ``self.agg.quantiles()``,
  ``self.states[i].hll``) can't be typed without running the code, so it
  falls back to name-keyed candidates — but only (a) top-level defs and
  class methods in the SAME module and (b) a cross-module method of that
  name when exactly ONE class among the caller's imported modules
  defines it (unique ⇒ unambiguous; the port's ``TorchAggregator`` and
  ``TorchStorage`` methods resolve this way from their callers). Nested
  ``<locals>`` defs are never fallback candidates — they aren't
  addressable as attributes. Fallback edges carry ``resolved=False`` so
  precision-sensitive rules (ZT08 traced-reach, taint summaries) can
  ignore them while fence rules (ZT07/ZT13) keep the over-approximation.

- **Bounded-depth reachability** (:meth:`CallGraph.reach`) with cycle
  tolerance and predecessor chains for ``via f() → g()`` messages;
  ``DEFAULT_DEPTH`` is the "full interprocedural depth" of ZT13.

- **Cross-module taint summaries** (:meth:`CallGraph.returns_tainted`):
  does a function return a device-tainted value? Computed lazily over
  resolved edges with memoization and a cycle guard, layered over
  :mod:`zipkin_tpu_torch.lint.taint`'s per-function dataflow so
  ZT01/ZT02 can see a device pull hiding behind a cross-module helper.

The graph is built ONCE per lint run (``core.run_paths``) and shared by
every rule; modules are parse-cached by mtime, so re-lints only re-read
what changed.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# "Full interprocedural depth": deep enough that no real call chain in
# the repo hits the cutoff (the longest shipped chain is < 10 frames),
# bounded so a pathological cycle-free blowup cannot hang the linter.
DEFAULT_DEPTH = 24

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)


def module_qualname(rel: str) -> str:
    """``zipkin_tpu_torch/tpu/store.py`` → ``zipkin_tpu_torch.tpu.store``;
    package ``__init__.py`` files take the package's own name."""
    name = rel[:-3] if rel.endswith(".py") else rel
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


class FunctionInfo:
    """One def in the program (module function, method, or nested)."""

    __slots__ = ("qual", "name", "module_rel", "module_qual", "node",
                 "cls", "marker_lines")

    def __init__(self, qual, name, module_rel, module_qual, node, cls):
        self.qual = qual
        self.name = name
        self.module_rel = module_rel
        self.module_qual = module_qual
        self.node = node
        self.cls = cls  # enclosing class name or None


class _ModuleIndex:
    """Per-module name tables the resolver consults."""

    __slots__ = ("module", "qual", "top_funcs", "classes", "bases",
                 "imports_mod", "imports_sym", "imported_quals")

    def __init__(self, module, qual):
        self.module = module
        self.qual = qual
        self.top_funcs: Dict[str, str] = {}       # bare -> qualname
        self.classes: Dict[str, Dict[str, str]] = {}   # cls -> meth -> qual
        self.bases: Dict[str, List[str]] = {}     # cls -> base name list
        self.imports_mod: Dict[str, str] = {}     # alias -> module qual
        self.imports_sym: Dict[str, str] = {}     # alias -> symbol qual
        self.imported_quals: Set[str] = set()     # module quals imported


class CallGraph:
    """The program: every parsed module, indexed and edge-connected."""

    def __init__(self, modules: Sequence) -> None:
        self.modules = list(modules)
        self.functions: Dict[str, FunctionInfo] = {}
        self._by_node: Dict[int, FunctionInfo] = {}   # id(def node) -> info
        self._index: Dict[str, _ModuleIndex] = {}     # module qual -> index
        self._mod_by_rel: Dict[str, object] = {}
        # adjacency: caller qual -> [(callee qual, resolved)]
        self.edges: Dict[str, List[Tuple[str, bool]]] = {}
        # per-call resolution: id(Call node) -> [(callee qual, resolved)]
        self._call_targets: Dict[int, List[Tuple[str, bool]]] = {}
        # bare method/function name -> [quals] (no <locals> entries)
        self._by_bare: Dict[str, List[str]] = {}
        self._taint_memo: Dict[str, bool] = {}
        for m in self.modules:
            self._register_module(m)
        for m in self.modules:
            self._build_edges(m)

    # -- registration -----------------------------------------------------

    def _register_module(self, module) -> None:
        qual = module_qualname(module.rel)
        idx = _ModuleIndex(module, qual)
        self._index[qual] = idx
        self._mod_by_rel[module.rel] = module
        for node in module.tree.body:
            self._register_imports(idx, node)
        self._register_scope(idx, module, module.tree.body, qual, None)
        # conditional / function-local imports still bind module aliases
        for node in ast.walk(module.tree):
            self._register_imports(idx, node)

    def _register_imports(self, idx: _ModuleIndex, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    idx.imports_mod[a.asname] = a.name
                else:
                    # ``import a.b.c`` binds root ``a``; the resolver
                    # re-joins the full dotted chain at the call site
                    idx.imports_mod[a.name.split(".")[0]] = \
                        a.name.split(".")[0]
                idx.imported_quals.add(a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            base = node.module
            if node.level:  # relative import: anchor at this package
                pkg = idx.qual.rsplit(".", node.level)[0]
                base = f"{pkg}.{node.module}" if node.module else pkg
            for a in node.names:
                bound = a.asname or a.name
                target = f"{base}.{a.name}"
                # ``from a.b import c`` may bind a submodule or a symbol;
                # record both readings, module table wins at resolve time
                idx.imports_sym[bound] = target
                idx.imports_mod.setdefault(bound, target)
                idx.imported_quals.add(base)
                idx.imported_quals.add(target)

    def _register_scope(self, idx, module, body, prefix, cls) -> None:
        for node in body:
            if isinstance(node, _FUNC_KINDS):
                qual = f"{prefix}.{node.name}"
                info = FunctionInfo(qual, node.name, module.rel, idx.qual,
                                    node, cls)
                self.functions[qual] = info
                self._by_node[id(node)] = info
                if cls is None and prefix == idx.qual:
                    idx.top_funcs[node.name] = qual
                if cls is not None and "<locals>" not in prefix:
                    idx.classes.setdefault(cls, {})[node.name] = qual
                if "<locals>" not in qual:
                    self._by_bare.setdefault(node.name, []).append(qual)
                self._register_scope(
                    idx, module, node.body, f"{qual}.<locals>", None
                )
            elif isinstance(node, ast.ClassDef):
                idx.classes.setdefault(node.name, {})
                idx.bases[node.name] = [
                    b.id if isinstance(b, ast.Name)
                    else (b.attr if isinstance(b, ast.Attribute) else "")
                    for b in node.bases
                ]
                self._register_scope(
                    idx, module, node.body, f"{prefix}.{node.name}",
                    node.name,
                )
            elif isinstance(node, (ast.If, ast.Try, ast.With,
                                   ast.AsyncWith)):
                inner = list(getattr(node, "body", []))
                inner += list(getattr(node, "orelse", []))
                inner += list(getattr(node, "finalbody", []))
                for hs in getattr(node, "handlers", []):
                    inner += hs.body
                self._register_scope(idx, module, inner, prefix, cls)

    # -- edge building ----------------------------------------------------

    def _build_edges(self, module) -> None:
        idx = self._index[module_qualname(module.rel)]
        for info in list(self.functions.values()):
            if info.module_rel != module.rel:
                continue
            out = self.edges.setdefault(info.qual, [])
            own_nested = set()
            for inner in ast.walk(info.node):
                if inner is not info.node and isinstance(inner, _FUNC_KINDS):
                    own_nested.update(
                        id(n) for n in ast.walk(inner) if n is not inner
                    )
                    own_nested.add(id(inner))
            for call in ast.walk(info.node):
                if not isinstance(call, ast.Call) or id(call) in own_nested:
                    continue  # nested defs own their calls
                targets = self._resolve_call(idx, info, call)
                if targets:
                    self._call_targets[id(call)] = targets
                    out.extend(targets)

    def _resolve_call(self, idx, info, call) -> List[Tuple[str, bool]]:
        f = call.func
        if isinstance(f, ast.Name):
            qual = self._resolve_bare(idx, info, f.id)
            return [(qual, True)] if qual else []
        if isinstance(f, ast.Attribute):
            return self._resolve_attr(idx, info, f)
        return []

    def _resolve_bare(self, idx, info, name) -> Optional[str]:
        """Python's lexical rules: enclosing functions' nested defs,
        module scope, then ``from x import f`` symbols. No name-keyed
        fallback — a bare name the scope can't see is a builtin."""
        prefix = info.qual
        while prefix:
            nested = f"{prefix}.<locals>.{name}"
            if nested in self.functions:
                return nested
            if "." not in prefix:
                break
            parent = prefix.rsplit(".<locals>.", 1)
            prefix = parent[0] if len(parent) == 2 else ""
        if name in idx.top_funcs:
            return idx.top_funcs[name]
        sym = idx.imports_sym.get(name)
        if sym and sym in self.functions:
            return sym
        return None

    def _class_method(self, idx, cls, meth, seen=None) -> Optional[str]:
        """``cls.meth`` with single-inheritance base walk (cycle-safe)."""
        seen = seen or set()
        if cls in seen or cls not in idx.classes:
            return None
        seen.add(cls)
        qual = idx.classes[cls].get(meth)
        if qual:
            return qual
        for base in idx.bases.get(cls, ()):
            hit = self._class_method(idx, base, meth, seen)
            if hit:
                return hit
            # base imported from another module: follow the symbol
            sym = idx.imports_sym.get(base)
            if sym:
                bidx = self._index.get(sym.rsplit(".", 1)[0])
                bname = sym.rsplit(".", 1)[1]
                if bidx is not None:
                    hit = self._class_method(bidx, bname, meth, seen)
                    if hit:
                        return hit
        return None

    def _resolve_attr(self, idx, info, f) -> List[Tuple[str, bool]]:
        parts = _attr_chain(f)
        meth = f.attr
        if parts is not None:
            root = parts[0]
            # self.m() / cls.m(): the enclosing class, bases included
            if root in ("self", "cls") and len(parts) == 2 and info.cls:
                qual = self._class_method(idx, info.cls, meth)
                if qual:
                    return [(qual, True)]
            # alias chains through the import table: mod.f, pkg.mod.f,
            # mod.Class.m — longest dotted prefix that names a module
            expanded = None
            if root in idx.imports_mod:
                expanded = [idx.imports_mod[root]] + parts[1:]
            elif root in idx.imports_sym:
                expanded = idx.imports_sym[root].split(".") + parts[1:]
            if expanded:
                for cut in range(len(expanded) - 1, 0, -1):
                    mod_qual = ".".join(expanded[:cut])
                    midx = self._index.get(mod_qual)
                    if midx is None:
                        continue
                    rest = expanded[cut:]
                    if len(rest) == 1 and rest[0] in midx.top_funcs:
                        return [(midx.top_funcs[rest[0]], True)]
                    if len(rest) == 2:
                        qual = self._class_method(midx, rest[0], rest[1])
                        if qual:
                            return [(qual, True)]
                    break
        # unknown receiver: conservative name-keyed fallback (module
        # docstring) — same-module defs + a uniquely-named imported
        # method; never nested <locals> defs
        out: List[Tuple[str, bool]] = []
        if meth in idx.top_funcs:
            out.append((idx.top_funcs[meth], False))
        for methods in idx.classes.values():
            if meth in methods:
                out.append((methods[meth], False))
        if not out:
            cross = [
                q for q in self._by_bare.get(meth, ())
                if self.functions[q].module_qual in idx.imported_quals
                or any(
                    iq.startswith(self.functions[q].module_qual + ".")
                    or self.functions[q].module_qual.startswith(iq + ".")
                    or iq == self.functions[q].module_qual
                    for iq in idx.imported_quals
                )
            ]
            if len(cross) == 1:
                out.append((cross[0], False))
        return out

    # -- queries -----------------------------------------------------------

    def info_for_node(self, node) -> Optional[FunctionInfo]:
        return self._by_node.get(id(node))

    def module_for(self, rel: str):
        """The parsed Module for a repo-relative path (None if absent)."""
        return self._mod_by_rel.get(rel)

    def qual_of(self, node) -> Optional[str]:
        info = self._by_node.get(id(node))
        return info.qual if info else None

    def callees_of_call(self, call) -> List[Tuple[str, bool]]:
        """Resolution of ONE Call node (empty if unresolvable)."""
        return self._call_targets.get(id(call), [])

    def callers_of(self, qual: str) -> List[str]:
        """Caller quals with any edge (resolved or fallback) into qual."""
        return [
            c for c, outs in self.edges.items()
            if any(t == qual for t, _ in outs)
        ]

    def call_sites_of(self, qual: str) -> List[Tuple[str, ast.Call]]:
        """(caller qual, Call node) pairs targeting ``qual``."""
        out = []
        for caller, outs in self.edges.items():
            if not any(t == qual for t, _ in outs):
                continue
            info = self.functions.get(caller)
            if info is None:
                continue
            for call in ast.walk(info.node):
                if isinstance(call, ast.Call) and any(
                    t == qual
                    for t, _ in self._call_targets.get(id(call), ())
                ):
                    out.append((caller, call))
        return out

    def reach(
        self,
        roots: Iterable[str],
        depth: int = DEFAULT_DEPTH,
        resolved_only: bool = False,
        same_module: bool = False,
    ) -> Dict[str, Tuple[str, int, Optional[str]]]:
        """BFS closure: qual → (root qual, depth, predecessor qual).

        Cycle-tolerant (visited set), bounded by ``depth`` hops.
        ``resolved_only`` drops name-keyed fallback edges;
        ``same_module`` prunes edges that leave the root's module (the
        ZT10 posture — cross-module depth is ZT13's job)."""
        out: Dict[str, Tuple[str, int, Optional[str]]] = {}
        frontier: List[Tuple[str, str, int, Optional[str]]] = [
            (q, q, 0, None) for q in roots if q in self.functions
        ]
        while frontier:
            nxt: List[Tuple[str, str, int, Optional[str]]] = []
            for qual, root, d, pred in frontier:
                if qual in out:
                    continue
                out[qual] = (root, d, pred)
                if d >= depth:
                    continue
                root_mod = self.functions[root].module_rel
                for callee, resolved in self.edges.get(qual, ()):
                    if callee in out or callee not in self.functions:
                        continue
                    if resolved_only and not resolved:
                        continue
                    if (
                        same_module
                        and self.functions[callee].module_rel != root_mod
                    ):
                        continue
                    nxt.append((callee, root, d + 1, qual))
            frontier = nxt
        return out

    def via_chain(self, reached, qual: str, limit: int = 4) -> str:
        """Human-readable ``via a() → b()`` suffix for findings."""
        names = []
        cur = qual
        while cur is not None and len(names) < limit:
            root, _d, pred = reached[cur]
            if pred is None:
                break
            names.append(self.functions[cur].name + "()")
            cur = pred
        if not names:
            return ""
        return " (via " + " → ".join(reversed(names)) + ")"

    # -- cross-module taint summaries --------------------------------------

    def returns_tainted(self, qual: str, _depth: int = 0) -> bool:
        """Does ``qual`` return a device-tainted value? Lazy, memoized,
        cycle-safe (an in-progress query answers False — the fixpoint
        seed), following resolved edges only."""
        if qual in self._taint_memo:
            return self._taint_memo[qual]
        info = self.functions.get(qual)
        if info is None or _depth > 8:
            return False
        self._taint_memo[qual] = False  # cycle guard / fixpoint seed
        from zipkin_tpu_torch.lint.taint import FunctionTaint

        def resolver(call: ast.Call) -> bool:
            return any(
                resolved and self.returns_tainted(t, _depth + 1)
                for t, resolved in self.callees_of_call(call)
            )

        taint = FunctionTaint(info.node, call_resolver=resolver,
                              lines=self._mod_by_rel[info.module_rel].lines)
        verdict = False
        for node in ast.walk(info.node):
            if isinstance(node, ast.Return) and node.value is not None:
                if taint.is_tainted(node.value):
                    verdict = True
                    break
        self._taint_memo[qual] = verdict
        return verdict

    @property
    def n_edges(self) -> int:
        return sum(len(v) for v in self.edges.values())


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` → ["a","b","c"]; None when any link isn't a plain
    Name/Attribute (a call or subscript in the chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None
