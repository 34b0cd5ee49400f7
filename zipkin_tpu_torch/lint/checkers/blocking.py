"""ZT06 — blocking CUDA sync on serving paths.

``torch.cuda.synchronize()`` — and a stream's or an event's
``.synchronize()``, ``torch.cuda.current_stream(...).synchronize()``
among them — stalls the calling thread until the card retires the work
queued before it. In benchmarks and evals that is the point (wall-clock
honesty); on a serving path it serializes the ingest pipeline behind the
card and hands the launch queue's depth to the caller. The ingest and
read planes are designed to overlap host and device work (the threaded
feeder, the lock-scoped dispatch-then-pull split in ``state_clone``); a
stray sync undoes that silently, and a CUDA graph cannot capture one.

Rule: any ``*.synchronize()`` call in library code — paths under
``benchmarks/``, ``evals/`` and ``tests/`` are exempt, as is the body of
a method itself NAMED ``block_until_ready`` (the deliberate sync seam the
exempt callers use). Legitimate library blockers (health checks, drain
seams, warm-up, timing a kernel with events) carry a scoped pragma
naming why blocking is the contract. The copy that ends a read is
ZT01's business (``readpack.device_get``), not this rule's.
"""

from __future__ import annotations

import ast

from zipkin_tpu_torch.lint.core import Checker, Module, register
from zipkin_tpu_torch.lint.taint import _attr_chain

_FUNC_KINDS = (ast.FunctionDef, ast.AsyncFunctionDef)
_EXEMPT_PATH_PARTS = ("benchmarks/", "evals/", "tests/", "test_")


def _sync_name(call: ast.Call):
    """A printable name for a blocking sync call, or None."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "synchronize"):
        return None
    path = _attr_chain(f)
    if path == ["torch", "cuda", "synchronize"]:
        return "torch.cuda.synchronize()"
    if isinstance(f.value, ast.Call):
        inner = _attr_chain(f.value.func)
        if inner and inner[-1] == "current_stream":
            return "current_stream().synchronize()"
    return ".synchronize()"


@register
class BlockingSync(Checker):
    rule = "ZT06"
    severity = "error"
    name = "blocking-sync"
    doc = "CUDA synchronize outside benchmarks/evals/tests"
    hint = (
        "let the pipeline overlap host and card work; if blocking IS "
        "the contract (drain/health/warm-up/timing), suppress on the def "
        "line saying so"
    )

    def check(self, module: Module):
        if any(part in module.rel for part in _EXEMPT_PATH_PARTS):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            what = _sync_name(node)
            if what is None:
                continue
            fn = next(iter(module.enclosing(node, _FUNC_KINDS)), None)
            if fn is not None and fn.name == "block_until_ready":
                continue  # the sync seam's own definition
            where = f" in {fn.name}()" if fn is not None else ""
            yield self.found(
                module,
                node,
                f"{what}{where} — serving-path host stall until the "
                "card's queue retires",
            )
