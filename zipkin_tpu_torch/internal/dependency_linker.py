"""Aggregate traces into parent->child service dependency links.

The port's own copy of ``zipkin_tpu/internal/dependency_linker.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/internal/DependencyLinker.java`` (SURVEY.md
§2.1, §3.5) — the computation the TPU tier accelerates. The host
implementation here is the **oracle**: the device path
(:mod:`zipkin_tpu_torch.ops.linker`) must match its edge counts exactly
(BASELINE config[2]).

Linking rules (breadth-first over the reassembled tree):

1. A CLIENT span with children is skipped: the server half(s) below it
   report the link with better knowledge of the server's identity.
2. A span with no kind but both local+remote service names is treated as a
   CLIENT span (uninstrumented RPC convention).
3. SERVER/CONSUMER spans link remoteServiceName (the caller) -> local;
   a root SERVER span with no remote has no known parent -> no link.
4. CLIENT/PRODUCER spans link local -> remoteServiceName (the callee).
5. PRODUCER/CONSUMER (messaging) spans need both sides known — there is no
   tree walk through a broker.
6. For RPC spans, the nearest ancestor with a kind (the "RPC ancestor")
   resolves the parent: a SERVER span prefers its instrumented tree caller
   over its own ``ca`` address annotation; a CLIENT span missing a local
   service name inherits the ancestor's. A CLIENT span whose service
   *differs* from its RPC ancestor's implies an uninstrumented hop between
   them, and that ancestor->client link is backfilled (with no error).
7. An error is counted when the contributing span has an ``error`` tag.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from zipkin_tpu_torch.internal.span_node import SpanNode, build_tree
from zipkin_tpu_torch.model.span import DependencyLink, Kind, Span


class DependencyLinker:
    """Stateful accumulator: feed traces via :meth:`put_trace`, read with
    :meth:`link`."""

    def __init__(self) -> None:
        self._calls: Dict[Tuple[str, str], int] = {}
        self._errors: Dict[Tuple[str, str], int] = {}

    def put_trace(self, spans: Sequence[Span]) -> "DependencyLinker":
        root = build_tree(spans)
        if root is None:
            return self
        for node in root.traverse():
            span = node.span
            assert span is not None
            kind = span.kind
            local = span.local_service_name
            remote = span.remote_service_name

            # Rule 1: defer the client side of an RPC to its server half.
            if kind is Kind.CLIENT and node.children:
                continue

            # Rule 2: unknown kind with both sides known acts like a client.
            if kind is None:
                if local is not None and remote is not None:
                    kind = Kind.CLIENT
                else:
                    continue

            if kind in (Kind.SERVER, Kind.CONSUMER):
                child, parent = local, remote
                if node.parent is None and parent is None:
                    continue  # rule 3: root server with unknown caller
            elif kind in (Kind.CLIENT, Kind.PRODUCER):
                parent, child = local, remote
            else:  # pragma: no cover - exhaustive over Kind
                continue

            is_error = span.is_error
            if kind in (Kind.PRODUCER, Kind.CONSUMER):
                if parent is None or child is None:
                    continue  # rule 5
                self._add(parent, child, is_error)
                continue

            # Rule 6: resolve the parent via the nearest RPC ancestor. For a
            # SERVER span the tree ancestor (the instrumented caller) is
            # more reliable than the ca address annotation, so it wins.
            rpc_ancestor = _find_rpc_ancestor(node)
            if rpc_ancestor is not None:
                ancestor_name = rpc_ancestor.local_service_name
                if ancestor_name is not None:
                    # Rule 6b: a CLIENT span whose service differs from its
                    # RPC ancestor's implies an uninstrumented hop between
                    # them — backfill that link (error unknown, so none).
                    if (
                        kind is Kind.CLIENT
                        and local is not None
                        and ancestor_name != local
                    ):
                        self._add(ancestor_name, local, False)
                    if kind is Kind.SERVER or parent is None:
                        parent = ancestor_name

            if parent is None or child is None:
                continue
            self._add(parent, child, is_error)
        return self

    def put_links(self, links: Sequence[DependencyLink]) -> "DependencyLinker":
        """Merge pre-aggregated links (the daily-rollup read path)."""
        for link in links:
            key = (link.parent, link.child)
            self._calls[key] = self._calls.get(key, 0) + link.call_count
            self._errors[key] = self._errors.get(key, 0) + link.error_count
        return self

    def _add(self, parent: str, child: str, is_error: bool) -> None:
        key = (parent, child)
        self._calls[key] = self._calls.get(key, 0) + 1
        if is_error:
            self._errors[key] = self._errors.get(key, 0) + 1

    def link(self) -> List[DependencyLink]:
        return [
            DependencyLink(
                parent=parent,
                child=child,
                call_count=calls,
                error_count=self._errors.get((parent, child), 0),
            )
            for (parent, child), calls in self._calls.items()
        ]


def _find_rpc_ancestor(node: SpanNode) -> Optional[Span]:
    """Nearest ancestor span that has a kind (skipping local spans)."""
    ancestor = node.parent
    while ancestor is not None:
        span = ancestor.span
        if span is not None and span.kind is not None:
            return span
        ancestor = ancestor.parent
    return None


def link_traces(traces: Sequence[Sequence[Span]]) -> List[DependencyLink]:
    linker = DependencyLinker()
    for trace in traces:
        linker.put_trace(trace)
    return linker.link()
