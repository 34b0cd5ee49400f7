"""Trace reassembly: build a span tree from the spans of one trace.

The port's own copy of ``zipkin_tpu/internal/span_node.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/internal/SpanNode.java`` and
``zipkin2/internal/Trace.java`` (SURVEY.md §2.1). The builder tolerates
real-world dirt: missing parents (dangling spans attach to the root),
multiple roots (a synthetic root adopts them), mixed v1 shared spans (the
shared SERVER half of an RPC parents under the CLIENT half with the same id),
and duplicate reports (merged field-wise).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

from zipkin_tpu_torch.model.span import Span, merge_spans


class SpanNode:
    """A node in the reassembled trace tree."""

    __slots__ = ("span", "parent", "children")

    def __init__(self, span: Optional[Span]) -> None:
        self.span = span  # None only for a synthetic root
        self.parent: Optional[SpanNode] = None
        self.children: List[SpanNode] = []

    def add_child(self, child: "SpanNode") -> None:
        child.parent = self
        self.children.append(child)

    def traverse(self) -> Iterator["SpanNode"]:
        """Breadth-first traversal (the order DependencyLinker relies on)."""
        queue = collections.deque([self])
        while queue:
            node = queue.popleft()
            if node.span is not None:
                yield node
            queue.extend(node.children)

    @property
    def is_synthetic_root(self) -> bool:
        return self.span is None


def build_tree(spans: Sequence[Span]) -> Optional[SpanNode]:
    """Assemble one trace's spans into a tree; returns the root (possibly
    synthetic) or None for empty input.

    Keying: a span is located by its id; the shared (server) half of an RPC
    shares its id with the client half, so shared spans key separately and
    the client half with the same id is their preferred parent. Children of
    a shared server span sent by downstream instrumentation reference the
    shared id too, and attach below the server half.
    """
    if not spans:
        return None

    # Merge duplicate reports of the same span identity first. The key must
    # match Span.key() (id, shared, service) — two spans reusing an id with
    # different services are distinct nodes, not duplicates.
    merged: Dict[tuple, Span] = {}
    for span in spans:
        key = (span.id, bool(span.shared), span.local_service_name)
        if key in merged:
            try:
                merged[key] = merge_spans(merged[key], span)
            except ValueError:
                # e.g. mixed 64/128-bit renditions under lenient trace ids:
                # keep the first report rather than failing the whole trace
                pass
        else:
            merged[key] = span

    nodes: Dict[tuple, SpanNode] = {
        key: SpanNode(span) for key, span in merged.items()
    }

    # Index the primary (non-shared) node per id for parent lookups.
    primary_by_id: Dict[str, SpanNode] = {}
    shared_by_id: Dict[str, List[SpanNode]] = {}
    for node in nodes.values():
        s = node.span
        assert s is not None
        if s.shared:
            shared_by_id.setdefault(s.id, []).append(node)
        else:
            # If duplicates (shouldn't happen post-merge), first wins.
            primary_by_id.setdefault(s.id, node)

    root: Optional[SpanNode] = None
    dangling: List[SpanNode] = []

    for node in nodes.values():
        s = node.span
        assert s is not None
        if s.shared:
            # Shared server half: parent is the client half with the same id,
            # else fall back to its parentId.
            parent = primary_by_id.get(s.id)
            if parent is not None and parent is not node:
                parent.add_child(node)
                continue
            if s.parent_id is not None and s.parent_id in primary_by_id:
                primary_by_id[s.parent_id].add_child(node)
                continue
            dangling.append(node)
        elif s.parent_id is None:
            if root is None:
                root = node
            else:
                dangling.append(node)
        else:
            parent = _choose_parent(
                s, primary_by_id.get(s.parent_id), shared_by_id.get(s.parent_id)
            )
            if parent is not None and parent is not node:
                parent.add_child(node)
            else:
                dangling.append(node)

    if root is None and len(dangling) == 1 and not dangling[0].children:
        return dangling[0]
    if root is not None and not dangling:
        return root
    synthetic = SpanNode(None)
    if root is not None:
        synthetic.add_child(root)
    for node in dangling:
        synthetic.add_child(node)
    # A synthetic root with a single child is just that child.
    if len(synthetic.children) == 1:
        only = synthetic.children[0]
        only.parent = None
        return only
    return synthetic


def _choose_parent(
    child: Span,
    primary: Optional[SpanNode],
    shared: Optional[List[SpanNode]],
) -> Optional[SpanNode]:
    """Pick which half of an RPC a child span nests under.

    When the parent id was an RPC split into a client half and a shared
    server half, work done downstream belongs to the server's process — so
    prefer the half whose service matches the child's, then the server half.
    Mirrors the endpoint-aware parent matching in ``SpanNode.Builder``.
    """
    service = child.local_service_name
    if shared:
        for node in shared:
            if node.span is not None and node.span.local_service_name == service:
                return node
    if (
        primary is not None
        and primary.span is not None
        and primary.span.local_service_name == service
    ):
        return primary
    if shared:
        return shared[0]
    return primary


def merge_trace(spans: Sequence[Span]) -> List[Span]:
    """De-duplicate a trace's spans (same identity merged field-wise) and
    order them for presentation: by timestamp, then id, shared halves after
    their client halves.

    Reference: ``zipkin2/internal/Trace.java#merge``, including its rendition
    unification: when both a 128-bit and a 64-bit rendition of the trace id
    appear (lenient trace-id mode during instrumentation migrations), 64-bit
    spans are rewritten to the 128-bit form before merging, so duplicate
    reports of one span collapse instead of surviving under two ids.
    """
    tid128: Dict[str, str] = {}
    for span in spans:
        if len(span.trace_id) == 32:
            tid128.setdefault(span.trace_id[16:], span.trace_id)
    if tid128:
        spans = [
            dataclasses.replace(s, trace_id=tid128[s.trace_id])
            if len(s.trace_id) == 16 and s.trace_id in tid128
            else s
            for s in spans
        ]
    merged: Dict[tuple, Span] = {}
    for span in spans:
        key = span.key()
        if key in merged:
            merged[key] = merge_spans(merged[key], span)
        else:
            merged[key] = span
    return sorted(
        merged.values(),
        key=lambda s: (s.timestamp_as_long() or 2**63, s.id, bool(s.shared)),
    )
