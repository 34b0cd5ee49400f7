"""Pipeline observability: flight recorder + slow-dispatch self-spans
(the port's copy of ``zipkin_tpu/obs``).

``RECORDER`` is the process-wide stage recorder; instrumented host paths
call ``obs.record(stage, dur_s)`` with a stage-name literal from
:mod:`zipkin_tpu_torch.obs.stages` (``tests/test_torch_obs_recorder.py``
holds every literal in the package to the catalogue), never inside a device
program. Disable with ``TPU_OBS=0`` — every record becomes one predicate
check. This package and every module in it but :mod:`.device` import no
torch, so the spawned parse workers may import it.

``record_relayed`` is the histogram-only sibling for stage walls
measured elsewhere (worker processes) and relayed to the recording
thread — no budget/self-span path, so relayed time is never B3-linked
to the dispatcher's unrelated request context.

``selfspans``, ``windows``, ``device``, ``slo`` and the accuracy plane
are imported lazily by the server (they pull in more machinery);
low-level modules importing ``obs`` pay only for the recorder.
"""

import os

from zipkin_tpu_torch.obs.stages import (  # noqa: F401
    DEFAULT_BUDGETS_US,
    NUM_STAGES,
    STAGE_INDEX,
    STAGES,
)
from zipkin_tpu_torch.obs.recorder import (  # noqa: F401
    NUM_BUCKETS,
    Snapshot,
    StageRecorder,
    StageStat,
    bucket_index,
    bucket_le_us,
)

RECORDER = StageRecorder(
    enabled=os.environ.get("TPU_OBS", "1").strip().lower()
    not in ("0", "false", "no"),
)

record = RECORDER.record
record_relayed = RECORDER.record_relayed
