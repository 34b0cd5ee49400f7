"""ZT-lint for the port: static analysis of the invariants the CUDA path
rests on (the port's copy of ``zipkin_tpu/lint``).

The rules are the reference's fourteen, with the device rules retargeted
at torch: one counted device->host copy per read
(``zipkin_tpu_torch/readpack.py``), no stray CUDA syncs on serving
paths, no kernel builds or graph captures per call, in-place state
programs whose old binding is not read again, no full sorts on the fresh
read, lock-coherent shared state, seqlocked shared memory, committed
durable files, lock-free readers and admitted ingest boundaries. The
framework (:mod:`.core`), the whole-program call graph
(:mod:`.callgraph`) and the device-taint pass (:mod:`.taint`) are kept
here as the port's own copies; pragmas, baselines and the CLI
(``python -m zipkin_tpu_torch.lint``, ``--format json``/``--stats``) work
as the reference's do. ``tests/test_torch_lint_clean.py`` runs the
port's tree through it.

Import note: nothing here imports torch, numpy or jax — the linter
parses source, it never executes it, so it runs in any stdlib-only
context (``import zipkin_tpu_torch`` loads nothing either).
"""

from zipkin_tpu_torch.lint.core import (  # noqa: F401
    Checker,
    Finding,
    Module,
    RunResult,
    all_checkers,
    load_baseline,
    register,
    run_paths,
    write_baseline,
)
