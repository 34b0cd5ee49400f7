"""Device-value taint analysis (syntactic, per-function + summaries).

ZT01/ZT02 must tell ``np.asarray(qs)`` (input coercion of a host list)
apart from ``self.states[0].hist.cpu()`` (a device->host copy). There is
no type information at lint time, so this module runs a small forward
dataflow pass per function: an expression is *device-tainted* when it is
built from

- a parameter annotated as a tensor or one of the port's tuples of
  tensors (:data:`DEVICE_TYPES`: ``x: torch.Tensor``,
  ``state: AggState``), or named by a ``# zt-device: <param>[, ...] —
  reason`` comment on the def's signature lines (a ``SpanColumns`` is
  host columns or device ones; the marker says which),
- the aggregator state (any attribute/subscript chain with a ``.state``
  or ``.states`` segment — ``self.states[i].hll``, ``agg.states`` — or a
  bare ``state``/``states`` name: the per-shard state tuples every
  program takes),
- a ``torch.*`` call (device tensors are born there), except the
  host-only calls of :data:`HOST_ONLY_TORCH_ATTRS` and anything under
  ``torch.cuda`` (device handles, streams, events, counts — metadata,
  not tensors),
- a method call on a tainted receiver (``x.sum()``, ``x.to(...)``,
  ``x[mask]``), except the coercions themselves (``.cpu()``,
  ``.numpy()``, ``.item()``, ``.tolist()`` hand back host values, as do
  the readpack chokepoint's ``pull``/``device_get``),
- any call that RECEIVES a tainted argument (the state programs are
  opaque callables; what flows in device-flavored comes out
  device-flavored), or
- a call whose callee the whole-program graph RESOLVES to a function
  that returns a tainted value (``call_resolver`` — the cross-module
  summary hook :meth:`CallGraph.returns_tainted` plugs in),

propagated through names: assignment / tuple-unpack / for-targets of a
tainted value taint the bound names. Two passes over the statement list
approximate a fixpoint (enough for loops that bind before use).

Deliberately syntactic: no false negatives on the shapes that cost a
transfer each (several copies of one read's outputs) and few false
positives on host-only numpy code. Interprocedural flow comes in ONLY
via summaries over resolved call-graph edges, which keeps the fallback
(name-keyed) edges from smearing taint onto unrelated host code.
"""

from __future__ import annotations

import ast
import re
from typing import Optional, Sequence, Set

from zipkin_tpu_torch.lint.callgraph import _attr_chain

DEVICE_ROOT_MODULES = {"torch"}
STATE_ATTRS = {"state", "states"}

# parameter annotations that hold device tensors: torch.Tensor and the
# port's named tuples of tensors (the state, the link machinery's inputs
# and contexts); a batch's SpanColumns is host or device, so a
# ``# zt-device:`` marker names it instead
DEVICE_TYPES = {
    "Tensor", "AggState", "LinkInput", "LinkContext", "CtxStruct",
}

DEVICE_MARKER_RE = re.compile(
    r"#\s*zt-device:\s*(?P<params>[A-Za-z_]\w*(?:\s*,\s*[A-Za-z_]\w*)*)"
)

# torch.* calls that return host-side METADATA or host tensors (device
# handles, sizes, dtypes' info, seeds, wrapped numpy buffers), not
# device tensors — a coercion of these is not a transfer. Every call
# under ``torch.cuda`` is host-only too (see _host_only_torch_call).
HOST_ONLY_TORCH_ATTRS = {
    "device",
    "Size",
    "is_available",
    "device_count",
    "current_device",
    "get_device_name",
    "get_device_properties",
    "is_tensor",
    "is_floating_point",
    "numel",
    "finfo",
    "iinfo",
    "manual_seed",
    "Generator",
    "get_num_threads",
    "set_num_threads",
    "from_numpy",
    "no_grad",
    "inference_mode",
    "set_sync_debug_mode",
    "get_sync_debug_mode",
}

# tensor methods whose result lives on the host: the coercions ZT01
# flags (their results carry no taint — the copy already happened) and
# the metadata accessors (sizes, strides, devices: no copy at all)
COERCION_METHODS = {"cpu", "numpy", "item", "tolist"}
META_METHODS = {
    "size", "numel", "nelement", "dim", "element_size", "stride",
    "data_ptr", "is_contiguous", "get_device", "storage_offset",
}
# the counted chokepoint's calls (readpack.pull / device_get / unpack and
# an aggregator's _pull) hand back numpy: their results are host values
HOST_PULL_CALLS = {"pull", "_pull", "device_get", "unpack"}
# tensor attributes that are host metadata, not device values
META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout"}


def is_cpu_move(call: ast.AST) -> bool:
    """``x.to("cpu")`` / ``x.to(torch.device("cpu"))`` /
    ``x.to(device="cpu")``: a device->host copy spelled as a move."""
    if not (
        isinstance(call, ast.Call)
        and isinstance(call.func, ast.Attribute)
        and call.func.attr == "to"
    ):
        return False
    dests = list(call.args[:1]) + [
        k.value for k in call.keywords if k.arg == "device"
    ]
    for d in dests:
        if isinstance(d, ast.Call) and _attr_chain(d.func) == [
            "torch", "device",
        ] and d.args:
            d = d.args[0]
        if isinstance(d, ast.Constant) and d.value == "cpu":
            return True
    return False


def _root_name(node: ast.AST):
    """The leftmost Name of an attribute/subscript/call chain, if any."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_state_chain(node: ast.AST) -> bool:
    """True for ``self.states``, ``self.states[0].pend_pos``,
    ``self.agg.states[i].hll``, ``state.hll``... — an attribute/subscript
    chain with a ``.state``/``.states`` segment (or a bare
    ``state``/``states`` name): the aggregator state however it is
    reached."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in STATE_ATTRS:
            return True
        node = node.value
    return isinstance(node, ast.Name) and node.id in STATE_ATTRS


def _is_meta_chain(node: ast.AST) -> bool:
    """``x.shape``, ``x.shape[0]``, ``self.states[0].hist.dtype``: an
    attribute/subscript chain through host metadata."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in META_ATTRS:
            return True
        node = node.value
    return False


def _host_only_torch_call(func: ast.AST) -> bool:
    """A ``torch.*`` callee that returns metadata or a host tensor."""
    path = _attr_chain(func)
    if path is None:
        return False
    if len(path) >= 2 and path[1] == "cuda":
        return True  # streams, events, device counts, memory stats
    return path[-1] in HOST_ONLY_TORCH_ATTRS


def marked_device_params(lines: Sequence[str], fn: ast.AST) -> Set[str]:
    """The parameters a ``# zt-device:`` comment on ``fn``'s signature
    lines names (``lines`` the module's source lines; a comment line before
    the body's first statement belongs to the body)."""
    body = getattr(fn, "body", None)
    if not isinstance(body, list) or not hasattr(fn, "lineno"):
        return set()
    out: Set[str] = set()
    end = body[0].lineno if body else fn.lineno + 1
    for line_no in range(fn.lineno, min(end, len(lines) + 1)):
        text = lines[line_no - 1].strip()
        if line_no > fn.lineno and text.startswith("#"):
            break
        m = DEVICE_MARKER_RE.search(text)
        if m:
            out.update(p.strip() for p in m.group("params").split(","))
    return out


def _device_annotation(ann: ast.AST) -> bool:
    """``torch.Tensor``, ``AggState``, ``Optional[torch.Tensor]``...
    (string annotations included)."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    for n in ast.walk(ann):
        if isinstance(n, ast.Name) and n.id in DEVICE_TYPES:
            return True
        if isinstance(n, ast.Attribute) and n.attr in DEVICE_TYPES:
            return True
    return False


class FunctionTaint:
    """Taint facts for one function body (nested defs included).

    ``call_resolver`` is an optional ``Call node -> bool`` oracle: when
    the local rules don't taint a call, the resolver may (cross-module
    summary: the resolved callee returns a device value). ``lines``, the
    module's source lines, lets ``# zt-device:`` markers taint parameters."""

    def __init__(self, fn: ast.AST, call_resolver=None,
                 lines: Optional[Sequence[str]] = None) -> None:
        self.fn = fn
        self.call_resolver = call_resolver
        self.tainted_names: Set[str] = set()
        args = getattr(fn, "args", None)
        if isinstance(args, ast.arguments):
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if a.annotation is not None and _device_annotation(
                    a.annotation
                ):
                    self.tainted_names.add(a.arg)
            if lines is not None:
                named = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
                self.tainted_names.update(named & marked_device_params(lines, fn))
        body = getattr(fn, "body", [])
        comps = [
            n for n in ast.walk(fn)
            if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp))
        ]
        for _ in range(2):  # two passes ≈ fixpoint for name-level flow
            for stmt in body:
                self._visit_stmt(stmt)
            # a comprehension over a tainted iterable binds tainted
            # targets (``[s.hll.cpu() for s in agg.states]``)
            for comp in comps:
                for gen in comp.generators:
                    if self.is_tainted(gen.iter):
                        self._taint_target(gen.target)

    # -- statement walk (assignments bind taint to names) ----------------

    def _visit_stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.Assign):
            if self.is_tainted(stmt.value):
                for target in stmt.targets:
                    self._taint_target(target)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None and self.is_tainted(stmt.value):
                self._taint_target(stmt.target)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            if self.is_tainted(stmt.iter):
                self._taint_target(stmt.target)
            for s in stmt.body + stmt.orelse:
                self._visit_stmt(s)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None and self.is_tainted(
                    item.context_expr
                ):
                    self._taint_target(item.optional_vars)
            for s in stmt.body:
                self._visit_stmt(s)
        elif isinstance(stmt, (ast.If, ast.While)):
            for s in stmt.body + stmt.orelse:
                self._visit_stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in (
                stmt.body
                + stmt.orelse
                + stmt.finalbody
                + [h for hs in stmt.handlers for h in hs.body]
            ):
                self._visit_stmt(s)
        # nested defs keep their own scopes; don't descend

    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted_names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)
        # attribute/subscript targets don't bind local names

    # -- expression taint -------------------------------------------------

    def is_tainted(self, node: ast.AST) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted_names or node.id in STATE_ATTRS
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            if _is_meta_chain(node):
                return False
            if _is_state_chain(node):
                return True
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            callee = (node.func.attr if isinstance(node.func, ast.Attribute)
                      else getattr(node.func, "id", None))
            if callee in HOST_PULL_CALLS:
                return False
            root = _root_name(node.func)
            if root in DEVICE_ROOT_MODULES and isinstance(
                node.func, ast.Attribute
            ):
                return not _host_only_torch_call(node.func)
            if isinstance(node.func, ast.Attribute):
                if (
                    node.func.attr in COERCION_METHODS
                    or node.func.attr in META_METHODS
                    or is_cpu_move(node)
                ):
                    return False
                if self.is_tainted(node.func.value):
                    return True  # a tensor method: x.sum(), x.to(dev)
            if any(self.is_tainted(a) for a in node.args):
                return True
            if any(self.is_tainted(k.value) for k in node.keywords):
                return True
            if self.call_resolver is not None and self.call_resolver(node):
                return True
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.Compare):
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators
            )
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(el) for el in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.NamedExpr):
            return self.is_tainted(node.value)
        return False
