"""ZT04 — lock discipline across methods of a class.

The shape this pins: state updated under a lock on one path and
lock-free on another — a vocab sidecar's persisted mark and its
``os.replace`` (a delayed writer replaced a NEWER sidecar with an older
one), or an event queue appended under its lock in one method and
swapped out without it in another. The ingest and read planes share
mutable sketch state across threads, exactly where silent races are
born.

Rule: within one class, collect the lock attributes (``self.x =
threading.Lock()/RLock()/Condition()`` — any assignment whose value is
a ``threading.*`` constructor call). An instance attribute is
*lock-associated* when some method writes it inside a ``with
self.<lock>:`` block. Every OTHER write to that attribute (plain
assignment, augmented assignment, or ``self.attr[...] = ...`` item
write) outside any with-lock block — in any method except ``__init__``
(construction precedes concurrency) — is a finding.

"Callers hold the lock" helper methods are real and common (the
aggregator's ``_flush_now``). When the call graph can PROVE the claim —
every in-graph call site of the method is a same-class call lexically
inside ``with self.<lock>:`` — the write is accepted without ceremony;
the scoped pragma on the ``def`` line (justification naming the lock)
remains for the cases the graph can't see (callbacks, cross-class
protocols, calls from outside the linted tree). One unguarded caller
kills the proof: that caller IS the race.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from zipkin_tpu_torch.lint.core import Checker, Module, register
from zipkin_tpu_torch.lint.taint import _root_name

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)
# InstrumentedRLock (obs/querytrace.py) is a drop-in RLock with a
# contention ledger — the aggregator's with-discipline must survive the
# swap, so ZT04 recognizes it as a lock constructor too.
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore", "InstrumentedRLock"}


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """self.X assigned from a threading.* lock constructor anywhere in
    the class body."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        ctor = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if ctor not in _LOCK_CTORS:
            continue
        if isinstance(f, ast.Attribute) and _root_name(f) not in (
            "threading",
            "multiprocessing",
            "mp",
            "querytrace",
        ):
            continue
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                out.add(t.attr)
    return out


def _self_attr_write(target: ast.AST):
    """'attr' when the assignment target writes self.attr or
    self.attr[...] (an item write mutates the shared container)."""
    if isinstance(target, ast.Subscript):
        target = target.value
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return target.attr
    return None


def _with_locks(module: Module, node: ast.AST, lock_attrs: Set[str]) -> bool:
    """Is ``node`` lexically inside a ``with self.<lock>:`` block?"""
    for w in module.enclosing(node, (ast.With, ast.AsyncWith)):
        for item in w.items:
            e = item.context_expr
            # with self.lock: / with self._cv: / with self.lock, other:
            if (
                isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and e.attr in lock_attrs
            ):
                return True
    return False


@register
class LockDiscipline(Checker):
    rule = "ZT04"
    severity = "error"
    name = "lock-discipline"
    doc = "attribute locked in one method, written lock-free in another"
    hint = (
        "take the same lock (or, if the caller provably holds it, "
        "suppress on the def line naming the lock)"
    )

    def check(self, module: Module):
        for cls in ast.walk(module.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(module, cls)

    def _check_class(self, module: Module, cls: ast.ClassDef):
        lock_attrs = _lock_attrs(cls)
        if not lock_attrs:
            return
        # every write site: (attr, node, method, guarded?)
        writes: List[Tuple[str, ast.AST, str, bool]] = []
        methods: Dict[str, ast.AST] = {}
        for method in cls.body:
            if not isinstance(method, _FUNC_KINDS):
                continue
            methods[method.name] = method
            for node in ast.walk(method):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    attr = _self_attr_write(t)
                    if attr is None or attr in lock_attrs:
                        continue
                    writes.append(
                        (
                            attr,
                            node,
                            method.name,
                            _with_locks(module, node, lock_attrs),
                        )
                    )
        guarded_attrs: Dict[str, Set[str]] = {}
        for attr, _, meth, guarded in writes:
            if guarded:
                guarded_attrs.setdefault(attr, set()).add(meth)
        callers_hold: Dict[str, bool] = {}
        for attr, node, meth, guarded in writes:
            if guarded or attr not in guarded_attrs or meth == "__init__":
                continue
            if meth not in callers_hold:
                callers_hold[meth] = self._callers_hold_lock(
                    module, methods[meth], lock_attrs
                )
            if callers_hold[meth]:
                continue  # the graph proves every call site holds it
            lockers = ", ".join(sorted(guarded_attrs[attr]))
            yield self.found(
                module,
                node,
                f"{cls.name}.{attr} written lock-free in {meth}() but "
                f"under a lock in {lockers}() — the sidecar-race shape",
            )

    def _callers_hold_lock(
        self, module: Module, method: ast.AST, lock_attrs: Set[str]
    ) -> bool:
        """The interprocedural caller-holds-the-lock proof: every
        in-graph call site is a same-class call made inside ``with
        self.<lock>:``. No callers ⇒ no proof (an entrypoint nobody
        calls locked is exactly the bug)."""
        graph = self.graph(module)
        qual = graph.qual_of(method)
        if qual is None:
            return False
        owner = qual.rsplit(".", 1)[0]  # module.Class prefix
        sites = graph.call_sites_of(qual)
        if not sites:
            return False
        for caller_qual, call in sites:
            if caller_qual.rsplit(".", 1)[0] != owner:
                return False  # cross-class call: same-named lock ≠ same lock
            caller_info = graph.functions[caller_qual]
            caller_mod = graph.module_for(caller_info.module_rel) or module
            if not _with_locks(caller_mod, call, lock_attrs):
                return False
        return True
