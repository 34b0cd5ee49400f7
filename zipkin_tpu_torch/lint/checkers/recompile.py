"""ZT03 — rebuild-per-call hazards, in torch form.

The port has no tracer of its own, but three constructions cost what a
JAX recompile costs — seconds to minutes of host wall — when they run on
a serving path instead of once:

- a kernel build: ``kernels.build(...)`` runs ``nvcc``, and
  ``ctypes.CDLL(...)`` loads a library (a fresh handle per call);
- ``torch.compile(...)``: a fresh compiled wrapper with an empty cache;
- ``torch.cuda.CUDAGraph()``: a graph that must be captured again.

Two shapes are flagged:

1. one of these *constructed* inside a loop body, or inside a plain
   function/method outside a loop. Module scope is fine; so is a cached
   factory: an enclosing function decorated with
   ``functools.lru_cache``/``cache``/``cached_property``, or one that
   memoizes by hand — it stores the result in a memo that outlives the
   call (a ``global`` it assigns, an item of a module-level mapping, or
   an item of a mapping the instance holds, ``self._graphs[key] = ...``)
   and tests that memo before building (``kernels.load``'s per-name
   cache under its lock, ``native._load``'s singleton, ``StepGraphs``'
   graph per step variant, lane count and shard).
2. a callable bound from ``torch.compile(...)`` without ``dynamic=``
   invoked with a varying Python scalar positionally — a loop variable,
   or an ``int()``/``float()`` coercion at the call site. The compiled
   code specializes on the value, so each new one recompiles; pass a
   tensor or declare the call dynamic.
"""

from __future__ import annotations

import ast
from typing import Set

from zipkin_tpu_torch.lint.core import Checker, Module, register
from zipkin_tpu_torch.lint.taint import _attr_chain

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)
_CACHE_DECORATORS = {"lru_cache", "cache", "cached_property"}


def _hazard(node: ast.AST):
    """The name of the rebuild hazard this call is, or None."""
    if not isinstance(node, ast.Call):
        return None
    path = _attr_chain(node.func)
    if path is None:
        return None
    if path == ["torch", "compile"]:
        return "torch.compile"
    if path in (["torch", "cuda", "CUDAGraph"], ["CUDAGraph"]):
        return "torch.cuda.CUDAGraph"
    if path in (["ctypes", "CDLL"], ["CDLL"]):
        return "ctypes.CDLL"
    if path == ["kernels", "build"]:
        return "kernels.build"
    return None


def _decorator_names(fn: ast.AST):
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Attribute):
            yield target.attr
        elif isinstance(target, ast.Name):
            yield target.id


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound in fn's own scope (params and plain assignments)."""
    out = {a.arg for a in ast.walk(fn.args) if isinstance(a, ast.arg)}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _instance_memo(node: ast.AST):
    """``self.attr`` (the chain as a string) when ``node`` reads a
    mapping the instance holds, else None."""
    if isinstance(node, ast.Attribute):
        path = _attr_chain(node)
        if path is not None and len(path) == 2 and path[0] == "self":
            return ".".join(path)
    return None


def _memoizes(fn: ast.AST) -> bool:
    """The hand-made cached factory: fn stores into a memo that outlives
    the call (an assigned ``global``, an item of a mapping it does not
    bind itself, or an item of ``self.<attr>``) and tests that memo — or a
    name read from it — in an ``if`` before building."""
    memo: Set[str] = set()
    attrs: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            memo.update(node.names)
    local = _local_names(fn) - memo
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            if isinstance(node.value, ast.Name) and node.value.id not in local:
                memo.add(node.value.id)
            elif _instance_memo(node.value) is not None:
                attrs.add(_instance_memo(node.value))
    if not memo and not attrs:
        return False

    def reads_memo(expr: ast.AST, names: Set[str]) -> bool:
        return any(
            (isinstance(n, ast.Name) and n.id in names)
            or _instance_memo(n) in attrs
            for n in ast.walk(expr)
        )

    derived = set(memo)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and reads_memo(node.value, memo):
            derived.update(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
    return any(
        isinstance(node, ast.If) and reads_memo(node.test, derived)
        for node in ast.walk(fn)
    )


def _compile_is_dynamic(call: ast.Call) -> bool:
    return any(k.arg == "dynamic" for k in call.keywords)


@register
class RecompileHazards(Checker):
    rule = "ZT03"
    severity = "error"
    name = "rebuild-hazards"
    doc = (
        "kernel builds, torch.compile or CUDA graphs per call/iteration; "
        "varying scalars into compiled callables"
    )
    hint = (
        "hoist the build to module scope or a cached factory; pass "
        "scalars as tensors or compile with dynamic=True"
    )

    def check(self, module: Module):
        if not module.imported_roots & {"torch", "ctypes", "zipkin_tpu_torch"}:
            return
        yield from self._construction_sites(module)
        yield from self._scalar_args_to_compiled(module)

    # -- shape 1: where is the hazard constructed? ------------------------

    def _construction_sites(self, module: Module):
        # decorator expressions evaluate at def time (module scope for
        # top-level defs) — @torch.compile is NOT a per-call construction
        in_decorator = set()
        for fn in ast.walk(module.tree):
            for dec in getattr(fn, "decorator_list", ()):
                in_decorator.update(ast.walk(dec))
        for node in ast.walk(module.tree):
            what = _hazard(node)
            if what is None or node in in_decorator:
                continue
            loop = next(
                iter(module.enclosing(node, (ast.For, ast.While))), None
            )
            if loop is not None:
                yield self.found(
                    module,
                    node,
                    f"{what} constructed inside a loop — every iteration "
                    "builds again with an empty cache",
                )
                continue
            enclosing_fns = list(module.enclosing(node, _FUNC_KINDS))
            if not enclosing_fns:
                continue  # module scope: built once per import
            if any(
                set(_decorator_names(fn)) & _CACHE_DECORATORS
                or _memoizes(fn)
                for fn in enclosing_fns
            ):
                continue  # the cached-factory pattern
            yield self.found(
                module,
                node,
                f"{what} constructed inside {enclosing_fns[0].name}() — "
                "a fresh build per call; hoist to module scope or cache "
                "the factory",
            )

    # -- shape 2: varying Python scalars hitting compiled callables -------

    def _scalar_args_to_compiled(self, module: Module):
        compiled: dict = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if _hazard(node.value) == "torch.compile" \
                        and not _compile_is_dynamic(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            compiled[t.id] = node.value
        if not compiled:
            return
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in compiled
            ):
                continue
            for arg in node.args:
                reason = self._varying_scalar(module, node, arg)
                if reason:
                    yield self.found(
                        module,
                        node,
                        f"compiled callable {node.func.id}() takes a "
                        f"{reason} positionally — each distinct value "
                        "recompiles (not declared dynamic)",
                    )
                    break

    def _varying_scalar(self, module: Module, call: ast.Call, arg: ast.AST):
        if (
            isinstance(arg, ast.Call)
            and isinstance(arg.func, ast.Name)
            and arg.func.id in ("int", "float")
        ):
            return "Python-scalar int()/float() coercion"
        if isinstance(arg, ast.Name):
            for loop in module.enclosing(call, (ast.For,)):
                t = loop.target
                names = (
                    {t.id}
                    if isinstance(t, ast.Name)
                    else {
                        el.id
                        for el in getattr(t, "elts", ())
                        if isinstance(el, ast.Name)
                    }
                )
                if arg.id in names:
                    return f"loop-varying Python scalar ({arg.id})"
        return None
