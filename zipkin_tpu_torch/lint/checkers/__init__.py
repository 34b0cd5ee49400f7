"""ZT-lint checkers. Importing this package registers every rule.

Rule catalog — the reference's fourteen, the device rules retargeted at
torch:

- ZT00 suppression hygiene (meta): a ``zt-lint: disable`` pragma with no
  justification text.
- ZT01 host-transfer chokepoint: a device→host copy (``.cpu()``,
  ``.numpy()``, ``.item()``, ``.tolist()``, ``.to("cpu")``,
  ``np.asarray``/``int()``/``float()``/``bool()`` of a device value) or a
  data-dependent-shape op that syncs on CUDA (``nonzero``, ``unique``,
  ``masked_select``, ``repeat_interleave`` without ``output_size``)
  outside ``readpack``.
- ZT02 multi-pull shapes: ≥2 host pulls in one function, or a return
  tuple of two or more copies.
- ZT03 rebuild hazards: a kernel build (``kernels.build``,
  ``ctypes.CDLL``), ``torch.compile`` or ``torch.cuda.CUDAGraph()``
  constructed per call/iteration outside a cached factory; varying
  Python scalars passed positionally to compiled callables.
- ZT04 lock discipline: attributes written under a lock in one method
  but lock-free in another.
- ZT05 in-place misuse: the argument of a ``# zt-in-place`` program read
  after the call without being rebound to its result.
- ZT06 blocking sync: ``torch.cuda.synchronize`` and stream/event
  ``.synchronize()`` on serving paths.
- ZT07 fresh-read ring sorts: sort-family ops (``torch.sort``,
  ``argsort``, ``msort``, ``unique``, ``u32.lexsort``) or calls back into
  the from-scratch ctx rebuilds reachable from fresh-read entrypoints
  — only the since-rollup delta segment may be sorted at query time.
- ZT08 obs stage discipline: ``obs.record`` reachable from code that
  runs once and replays (CUDA-graph capture, a program nested in a def
  marked ``# zt-captured``, ``make_graphed_callables``,
  ``torch.compile``), or a stage argument outside the closed taxonomy in
  ``obs/stages.py``.
- ZT09 dispatch-critical loops: Python ``for``/``while``/comprehensions
  inside functions marked ``# zt-dispatch-critical``.
- ZT10 mirror-served lock acquires: aggregator-lock acquisition reachable
  within the module from functions marked ``# zt-mirror-served``.
- ZT11 seqlock discipline: writes to registered shm seqlock regions (ring
  slot headers, mirror epoch, critpath ledger slots, recorder
  histograms) inside an odd/even generation bracket; gen-aware readers
  re-read the generation after copying.
- ZT12 durability commit: in ``wal``/``snapshot``/``timetier``/
  ``archive``, restore-readable files flow through tmp+fsync+rename+
  dir-fsync.
- ZT13 reader isolation: aggregator-lock / ``InstrumentedRLock``
  acquires unreachable, cross-module at full depth, from
  ``# zt-mirror-served`` and ``# zt-reader-process`` entrypoints.
- ZT14 tenant admission: every ``# zt-ingest-boundary`` wire entrypoint
  reaches a ``# zt-tenant-admission`` chokepoint in the call graph.

ZT07/ZT08/ZT13/ZT14 walk the shared whole-program call graph built once
per run (``lint/callgraph.py``); ZT01/ZT02/ZT04/ZT05/ZT09/ZT10 consult it
per module for summaries, caller proofs and callee hops.
"""

from zipkin_tpu_torch.lint.checkers import (  # noqa: F401 - import registers
    blocking,
    dispatchloop,
    donation,
    durability,
    freshread,
    locks,
    mirrorread,
    obsstage,
    pragmas,
    readeriso,
    recompile,
    seqlock,
    tenantadm,
    transfers,
)
