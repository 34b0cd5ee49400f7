"""ZT14 — tenant-admission coverage for ingest boundaries.

Tenant isolation is a fault-containment property: every
payload that enters from the wire must be attributed to a tenant and
charged against that tenant's budget BEFORE any parse or device
dispatch. The failure mode this rule guards against is the quiet
bypass: a new transport handler (or a refactored one) that hands bytes
to the fan-out tier without traversing admission — from then on a
flooding tenant's bytes are indistinguishable from everyone else's and
the isolation story silently rots.

Markers, program-wide (the ZT00 reason bar applies to both):

- ``# zt-ingest-boundary: <reason>`` — a wire entrypoint (HTTP ingest
  handler, gRPC Report, a future transport). These are the roots.
- ``# zt-tenant-admission: <reason>`` — an admission chokepoint
  (``Collector.accept_spans_bytes``, ``OverloadController.admit``).

From each boundary the whole-program call graph is walked; a boundary
from which NO admission-marked function is reachable is a finding, as
is a program that marks boundaries but no chokepoint at all.

The stock call graph only follows ``ast.Call`` edges, but boundary
handlers hop threads by *reference*: ``asyncio.to_thread(
self.collector.accept_spans_bytes, body, enc)`` passes the callee as
an argument. This checker augments the walk with callable-reference
edges — an ``ast.Attribute``/``ast.Name`` argument naming a known
function adds an edge from the enclosing function — so the to_thread
hop (and the grpc handler-registration hop) does not break the chain.
Over-approximate edges can only HIDE a missing-admission finding for a
chain the runtime never takes; they cannot invent one, so lint noise
stays zero.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from zipkin_tpu_torch.lint.core import Checker, register

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)

BOUNDARY_RE = re.compile(r"#\s*zt-ingest-boundary\b(?P<rest>.*)$")
ADMISSION_RE = re.compile(r"#\s*zt-tenant-admission\b(?P<rest>.*)$")

# comment lines immediately above a def that may carry its marker
_LOOKBACK_LINES = 8


def _marker_on(module, fn, pattern):
    """The marker attributed to ``fn``: anywhere in its body extent, or
    in the run of comment/blank lines immediately above the ``def``
    (both placements appear in the tree)."""
    end = getattr(fn, "end_lineno", None) or (fn.lineno + 1)
    for line_no in range(fn.lineno, end + 1):
        m = pattern.search(module.line_text(line_no))
        if m:
            return line_no, m.group("rest")
    for line_no in range(fn.lineno - 1,
                         max(0, fn.lineno - 1 - _LOOKBACK_LINES), -1):
        text = module.line_text(line_no).strip()
        if text and not text.startswith("#"):
            break
        m = pattern.search(text)
        if m:
            return line_no, m.group("rest")
    return None


def _reason_missing(rest: str) -> bool:
    return not rest.lstrip().startswith(":") or not rest.lstrip(": ").strip()


@register
class TenantAdmissionChain(Checker):
    rule = "ZT14"
    severity = "error"
    name = "tenant-admission"
    doc = (
        "ingest boundaries (# zt-ingest-boundary) from which no "
        "tenant-admission chokepoint (# zt-tenant-admission) is "
        "reachable in the whole-program call graph"
    )
    hint = (
        "route the payload through the admission chokepoint "
        "(Collector.accept_spans_bytes / OverloadController.admit) "
        "before any parse or device dispatch"
    )
    whole_program = True

    def check_program(self, program):
        roots: List[Tuple] = []
        chokepoints: Set[str] = set()
        for module in program.modules:
            for fn in ast.walk(module.tree):
                if not isinstance(fn, _FUNC_KINDS):
                    continue
                boundary = _marker_on(module, fn, BOUNDARY_RE)
                admission = _marker_on(module, fn, ADMISSION_RE)
                for hit, label in (
                    (boundary, "zt-ingest-boundary"),
                    (admission, "zt-tenant-admission"),
                ):
                    if hit is not None and _reason_missing(hit[1]):
                        yield self.found(
                            module, fn,
                            f"{label} marker without a reason — say WHY "
                            f"this function is part of the tenant "
                            f"admission contract (# {label}: <reason>)",
                        )
                qual = program.qual_of(fn)
                if qual is None:
                    continue
                if admission is not None:
                    chokepoints.add(qual)
                if boundary is not None:
                    roots.append((module, fn, qual))
        if not roots:
            return
        if not chokepoints:
            for module, fn, _qual in roots:
                yield self.found(
                    module, fn,
                    f"ingest boundary {fn.name}() is marked but the "
                    "program has no zt-tenant-admission chokepoint at "
                    "all — nothing attributes payloads to tenants",
                )
            return
        extra = self._callable_ref_edges(program)
        for module, fn, qual in roots:
            if qual in chokepoints:
                continue
            if not self._reaches(program, qual, chokepoints, extra):
                yield self.found(
                    module, fn,
                    f"ingest boundary {fn.name}() never traverses a "
                    "tenant-admission chokepoint — payloads from this "
                    "entrypoint reach the fan-out tier without being "
                    "charged to any tenant's budget",
                )

    # -- callable-reference edges ---------------------------------------

    @staticmethod
    def _callable_ref_edges(program) -> Dict[str, List[str]]:
        """Extra edges for callables passed by reference as call
        arguments (``asyncio.to_thread(f, ...)``, handler registration).
        Attribute args resolve name-keyed program-wide; bare-name args
        resolve within the same module (nested defs included)."""
        by_bare = getattr(program, "_by_bare", {})
        edges: Dict[str, List[str]] = {}
        for qual, info in program.functions.items():
            out: List[str] = []
            for call in ast.walk(info.node):
                if not isinstance(call, ast.Call):
                    continue
                for arg in list(call.args) + [
                    kw.value for kw in call.keywords
                ]:
                    if isinstance(arg, ast.Attribute):
                        out.extend(by_bare.get(arg.attr, ()))
                    elif isinstance(arg, ast.Name):
                        out.extend(
                            q for q in by_bare.get(arg.id, ())
                            if program.functions[q].module_rel
                            == info.module_rel
                        )
            if out:
                edges[qual] = out
        return edges

    @staticmethod
    def _reaches(program, root: str, targets: Set[str],
                 extra: Dict[str, List[str]], depth: int = 24) -> bool:
        seen = {root}
        frontier = [root]
        for _ in range(depth):
            if not frontier:
                break
            nxt: List[str] = []
            for qual in frontier:
                if qual in targets:
                    return True
                callees = [c for c, _r in program.edges.get(qual, ())]
                callees.extend(extra.get(qual, ()))
                for callee in callees:
                    if callee in seen or callee not in program.functions:
                        continue
                    seen.add(callee)
                    nxt.append(callee)
            frontier = nxt
        return bool(targets & seen)
