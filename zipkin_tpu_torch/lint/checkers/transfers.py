"""ZT01 / ZT02 — device->host transfer discipline, in torch form.

Every read of the port ends in ONE counted device->host copy through
``zipkin_tpu_torch.readpack`` (``pack`` on the card, ``device_get``'s one
``.cpu()``): a read that copies each output on its own pays the copy's
fixed cost once per output, and a CUDA sync with it. These checkers hold
the whole tree to that.

- **ZT01**: a device-tainted value (see :mod:`zipkin_tpu_torch.lint.taint`)
  brought to the host outside the sanctioned chokepoint module
  (``zipkin_tpu_torch/readpack.py``):

  - ``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``;
  - ``np.asarray`` / ``np.array`` of a tainted value;
  - ``int()`` / ``float()`` / ``bool()`` of a tainted value;
  - ``.to("cpu")`` / ``.to(torch.device("cpu"))``;
  - the data-dependent-shape ops that wait for the card to know their
    output size: ``torch.nonzero`` / ``.nonzero()``, single-argument
    ``torch.where``, ``torch.unique`` / ``.unique()``,
    ``torch.masked_select`` / ``.masked_select()``, and
    ``repeat_interleave`` of a tensor of repeats without ``output_size``;
  - a blocking upload — the other direction, and a sync all the same: a
    host copy from pageable memory waits for the stream before it
    returns, and a CUDA graph cannot capture it: ``torch.tensor`` /
    ``torch.as_tensor`` of host data with a ``device=`` other than
    ``"cpu"``, and ``.to(<device>)`` / ``.cuda()`` of a host tensor
    (``torch.from_numpy(...)``, or a name bound from one) without
    ``non_blocking=True``, and a store of a host value into a device
    tensor (``x[i] = 0``, ``x[idx] = n``: the value goes up as a one-element
    copy that waits for the stream; ``x[i:i + 1].fill_(n)`` passes it as a
    kernel argument instead).

  Route pulls through ``readpack.pull``/``readpack.device_get`` so
  ``hostTransfers`` counts them. Taint is per-function dataflow PLUS
  whole-program return summaries over resolved call-graph edges:
  ``helper(x).cpu()`` is a transfer when ``helper`` — in this module or
  another — returns a device value.
- **ZT02**: the multi-pull *shape* — ≥2 host pulls (the coercions above
  but the uploads, and the chokepoint's own pulls) in a single function (each pays the
  copy's round trip; pack on the card and pull once), or a return tuple
  of two or more copies (``return a.cpu(), b.cpu()``,
  ``return np.asarray(a), np.asarray(b)``) anywhere.
"""

from __future__ import annotations

import ast

from zipkin_tpu_torch.lint.core import Checker, Module, register
from zipkin_tpu_torch.lint.taint import (
    COERCION_METHODS,
    FunctionTaint,
    _attr_chain,
    _root_name,
    is_cpu_move,
)

# the sanctioned chokepoint: the ONE module allowed to copy to the host
# (its counter is what makes transfers-per-query observable)
CHOKEPOINT_PATH_SUFFIXES = ("zipkin_tpu_torch/readpack.py",)

UPLOAD = "blocking upload of host memory"
STORE = "host value stored into a device tensor"

# ops whose output size depends on the data: on CUDA each waits for the
# card (a hidden sync and a small copy) before it can allocate
SHAPE_SYNC_OPS = {"nonzero", "unique", "masked_select", "repeat_interleave"}

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_chokepoint(module: Module) -> bool:
    return module.rel.endswith(CHOKEPOINT_PATH_SUFFIXES)


def _np_coercion(call: ast.Call):
    """('asarray'|'array', arg) for np.asarray/np.array calls."""
    f = call.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr in ("asarray", "array")
        and isinstance(f.value, ast.Name)
        and f.value.id == "np"
        and call.args
    ):
        return f.attr, call.args[0]
    return None


def _is_coercion_call(call: ast.AST) -> bool:
    """The return-tuple shape's elements: np.asarray/np.array, ``.cpu()``,
    ``.numpy()`` or a move to the CPU — whatever taint can prove
    (``.item()``/``.tolist()`` are left out: numpy has them too)."""
    if not isinstance(call, ast.Call):
        return False
    if _np_coercion(call) is not None or is_cpu_move(call):
        return True
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr in ("cpu", "numpy")
        and not call.args
    )


def _device_get_call(call: ast.Call) -> bool:
    """readpack.device_get(...) or a bare device_get(...): the counted
    chokepoint, imported or qualified."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "device_get":
        return True
    return isinstance(f, ast.Name) and f.id == "device_get"


def _shape_sync(call: ast.Call, taint: FunctionTaint):
    """The data-dependent-shape op this call is, if its input is a
    device value: ``torch.nonzero(x)``/``x.nonzero()``, ``torch.where(c)``
    (one argument), ``torch.unique``, ``torch.masked_select``, or
    ``repeat_interleave`` without ``output_size``."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    path = _attr_chain(f)
    is_torch_fn = path is not None and len(path) == 2 and path[0] == "torch"
    if f.attr == "where":
        if is_torch_fn and len(call.args) == 1 and not call.keywords \
                and taint.is_tainted(call.args[0]):
            return "torch.where(cond)"
        return None
    if f.attr not in SHAPE_SYNC_OPS:
        return None
    if f.attr == "repeat_interleave" and any(
        k.arg == "output_size" for k in call.keywords
    ):
        return None
    if f.attr == "repeat_interleave":
        # only a tensor of repeats makes the output size data-dependent
        reps = [k.value for k in call.keywords if k.arg == "repeats"]
        if not reps and call.args:
            reps = [call.args[1 if is_torch_fn and len(call.args) > 1
                              else 0]]
        inputs = reps
    else:
        inputs = list(call.args) + [k.value for k in call.keywords]
        if not is_torch_fn:
            inputs.append(f.value)  # x.nonzero(): the receiver is the input
    if not any(taint.is_tainted(a) for a in inputs):
        return None
    return f"torch.{f.attr}" if is_torch_fn else f".{f.attr}()"


def _host_tensor_names(fn: ast.AST):
    """Names bound in ``fn`` from an expression that wraps host memory
    (``t = torch.from_numpy(a)``, ``t = torch.from_numpy(a).to(dtype)``)."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _wraps_host(node.value, out):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _wraps_host(node: ast.AST, host_names) -> bool:
    """A ``torch.from_numpy(...)`` at the root of a method chain, or a
    name already known to hold host memory — unless a link of the chain
    moves it to a device (``.to(dev)``, ``.cuda()``)."""
    while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if _attr_chain(node.func) == ["torch", "from_numpy"]:
            return True
        if node.func.attr == "cuda" or (
            node.func.attr == "to" and node.args and not _is_dtype(node.args[0])
        ):
            return False
        node = node.func.value
    return isinstance(node, ast.Name) and node.id in host_names


def _is_dtype(node: ast.AST) -> bool:
    """``torch.float32``, ``x.dtype`` or a ``*dtype(...)`` helper's result."""
    path = _attr_chain(node)
    if path is not None and (path[0] == "torch" or path[-1].lower().endswith("dtype")):
        return True
    if isinstance(node, ast.Call):
        name = _attr_chain(node.func) or []
        return bool(name) and name[-1].lower().endswith("dtype")
    return False


_DISPLAYS = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp, ast.DictComp)


def _container_names(fn: ast.AST):
    """Names bound in ``fn`` from a list/tuple/dict display: Python
    containers (that may hold tensors), not tensors."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, _DISPLAYS):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _host_store(node: ast.AST, taint: FunctionTaint, containers) -> bool:
    """``x[idx] = v`` with ``x`` a device tensor and ``v`` a host value (a
    Python number or bool, or a name or expression the taint pass does
    not hold for a device value)."""
    if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
        return False
    target = node.targets[0]
    return (
        isinstance(target, ast.Subscript)
        and not (isinstance(target.value, ast.Name) and target.value.id in containers)
        and taint.is_tainted(target.value)
        and not taint.is_tainted(node.value)
        and not isinstance(node.value, _DISPLAYS)
    )


def _blocking_upload(call: ast.Call, taint: FunctionTaint, host_names) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if any(k.arg == "non_blocking" for k in call.keywords):
        return False
    path = _attr_chain(f)
    if path in (["torch", "tensor"], ["torch", "as_tensor"]):
        dev = [k.value for k in call.keywords if k.arg == "device"]
        return bool(dev) and not (
            isinstance(dev[0], ast.Constant) and dev[0].value == "cpu"
        ) and not (call.args and taint.is_tainted(call.args[0]))
    if f.attr == "cuda" and not call.args:
        return _wraps_host(f.value, host_names)
    if f.attr != "to" or is_cpu_move(call) or not _wraps_host(f.value, host_names):
        return False
    dest = list(call.args[:1]) + [k.value for k in call.keywords if k.arg == "device"]
    return bool(dest) and not _is_dtype(dest[0])


def _iter_functions(module: Module):
    for node in ast.walk(module.tree):
        if isinstance(node, _FUNC_KINDS):
            yield node


def _taint_for(checker: Checker, module: Module, fn: ast.AST) -> FunctionTaint:
    """Per-function taint wired to the run's cross-module return
    summaries (resolved edges only) when the graph is available."""
    graph = checker.program
    if graph is None:
        return FunctionTaint(fn, lines=module.lines)

    def resolver(call: ast.Call) -> bool:
        return any(
            resolved and graph.returns_tainted(qual)
            for qual, resolved in graph.callees_of_call(call)
        )

    return FunctionTaint(fn, call_resolver=resolver, lines=module.lines)


def host_pulls(module: Module, fn: ast.AST, taint: FunctionTaint):
    """Every (node, kind) in ``fn`` that moves device data to host:
    tainted coercions, data-dependent-shape ops, and ``device_get``/
    ``self._pull``/``readpack.pull`` chokepoint calls (sanctioned, but
    each is still one transfer — two of them in one method is still
    the multi-pull shape)."""
    own = set()
    for inner in ast.walk(fn):
        if inner is not fn and isinstance(inner, _FUNC_KINDS):
            own.update(ast.walk(inner))
    host_names = _host_tensor_names(fn)
    containers = _container_names(fn)
    for node in ast.walk(fn):
        if node in own and node is not fn:
            # nested defs get their own function entry (and their own
            # taint scope) — don't double-count their pulls here
            continue
        if _host_store(node, taint, containers):
            yield node, STORE
            continue
        if not isinstance(node, ast.Call):
            continue
        if _device_get_call(node):
            yield node, "chokepoint pull"
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("pull", "_pull"):
            root = _root_name(f)
            if root in ("self", "readpack", "agg") or f.attr == "_pull":
                yield node, "chokepoint pull"
            continue
        coercion = _np_coercion(node)
        if coercion is not None:
            if taint.is_tainted(coercion[1]):
                yield node, f"np.{coercion[0]} of a device value"
            continue
        if (
            isinstance(f, ast.Name)
            and f.id in ("int", "float", "bool")
            and node.args
            and taint.is_tainted(node.args[0])
        ):
            yield node, f"{f.id}() of a device value"
            continue
        if (
            isinstance(f, ast.Attribute)
            and f.attr in COERCION_METHODS
            and not node.args
            and taint.is_tainted(f.value)
        ):
            yield node, f".{f.attr}() of a device value"
            continue
        if is_cpu_move(node) and taint.is_tainted(f.value):
            yield node, ".to('cpu') of a device value"
            continue
        shape = _shape_sync(node, taint)
        if shape is not None:
            yield node, f"{shape} (data-dependent shape: syncs on CUDA)"
            continue
        if _blocking_upload(node, taint, host_names):
            yield node, UPLOAD


@register
class HostTransferChokepoint(Checker):
    rule = "ZT01"
    severity = "error"
    name = "host-transfer-chokepoint"
    doc = "device→host copy, shape sync or blocking upload outside readpack"
    hint = (
        "route the pull through readpack.pull/readpack.device_get so "
        "hostTransfers counts it (zipkin_tpu_torch/readpack.py); give a "
        "data-dependent op a static bound (output_size, a fixed-size mask); "
        "pass a host number as a kernel argument (x[i:i + 1].fill_(n))"
    )

    def check(self, module: Module):
        if _is_chokepoint(module):
            return
        if "torch" not in module.imported_roots:
            # a module that never touches torch holds no device values;
            # np.asarray there is host-only input coercion
            return
        for fn in _iter_functions(module):
            taint = _taint_for(self, module, fn)
            for node, kind in host_pulls(module, fn, taint):
                if kind == "chokepoint pull":
                    continue  # sanctioned (counted) — ZT02 counts them
                what = (
                    "a host sync (the copy waits for the stream)"
                    if kind in (UPLOAD, STORE) else "a device→host transfer"
                )
                yield self.found(
                    module,
                    node,
                    f"{kind} in {fn.name}() — {what} outside the counted "
                    "readpack chokepoint",
                )


@register
class MultiPullShapes(Checker):
    rule = "ZT02"
    severity = "error"
    name = "multi-pull-shapes"
    doc = "≥2 host pulls per function / multi-coercion return tuples"
    hint = (
        "pack the program's outputs on the card (readpack.pack) and pull "
        "the one buffer once"
    )

    def check(self, module: Module):
        if _is_chokepoint(module):
            return
        has_torch = "torch" in module.imported_roots
        for fn in _iter_functions(module):
            if has_torch:
                taint = _taint_for(self, module, fn)
                pulls = [
                    p for p in host_pulls(module, fn, taint)
                    if p[1] not in (UPLOAD, STORE)
                ]
                if len(pulls) >= 2:
                    kinds = ", ".join(k for _, k in pulls)
                    yield self.found(
                        module,
                        pulls[1][0],
                        f"{fn.name}() makes {len(pulls)} host pulls "
                        f"({kinds}) — each pays the transport round trip",
                    )
            # `return a.cpu(), b.cpu()` is a multi-pull read being born
            # whatever the taint analysis can prove — reject the shape
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.Return)
                    and isinstance(node.value, ast.Tuple)
                ):
                    continue
                n_pulls = sum(
                    1 for el in node.value.elts if _is_coercion_call(el)
                )
                if n_pulls >= 2:
                    yield self.found(
                        module,
                        node,
                        f"return tuple with {n_pulls} host coercions in "
                        f"{fn.name}() — one transfer per element",
                    )
