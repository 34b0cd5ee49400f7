"""The step-graph captures made after the store's boot over the whole
run: the recompiles the device observatory counts for the ``spmd_step*``
programs (each heard from ``StepGraphs``' ``on_capture``). A capture in
the window stalls the feed; it should read 0."""


def read(ctx):
    if not ctx["ingest_call_s"]:
        return None
    from zipkin_tpu_torch.obs.device import OBSERVATORY

    return float(sum(row["recompiles"] for name, row in OBSERVATORY.programs().items()
                     if name.startswith("spmd_step")))
