"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that leaves the state
unchanged, half of each batch left out, an answer altered where the store
produces it, digests whose means drift while their weights stay exact.
(One card: no exchange between chips to leave out.)"""

import pytest
import torch

from portbench.tests.small import run_small


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    from zipkin_tpu_torch.tpu import ingest

    monkeypatch.setattr(ingest, "ingest_step", lambda config, state, batch: state)
    out = run_small("default.feed")
    assert out["correct"] is False and out["checks"]["counts_gap"]["value"] > 0


def test_half_of_each_batch_left_out(monkeypatch):
    from zipkin_tpu_torch.tpu import ingest

    step = ingest.ingest_step

    def half(config, state, batch):
        n = batch.valid.shape[0]
        keep = torch.arange(n, device=batch.valid.device) < n // 2
        return step(config, state, batch._replace(valid=batch.valid & keep))

    monkeypatch.setattr(ingest, "ingest_step", half)
    out = run_small("default.feed")
    assert out["correct"] is False and out["checks"]["hist_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["default.feed", "default.lens"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell):
    from zipkin_tpu_torch.tpu.store import TorchStorage

    links = TorchStorage._dependency_links

    def altered(self, lo_min, hi_min, fetch=None):
        out = links(self, lo_min, hi_min, fetch)
        if out:
            out[0] = out[0].__class__(parent=out[0].parent, child=out[0].child,
                                      call_count=out[0].call_count + 1,
                                      error_count=out[0].error_count)
        return out

    monkeypatch.setattr(TorchStorage, "_dependency_links", altered)
    out = run_small(cell)
    assert out["correct"] is False and out["checks"]["links_gap"]["value"] == 1
    if cell == "default.lens":
        assert out["checks"]["read_gap"]["value"] == 1


def test_digest_means_altered_where_they_are_merged(monkeypatch):
    from zipkin_tpu_torch.ops import tdigest

    merge = tdigest.row_merge

    def drifted(a, b):
        out = merge(a, b)
        return torch.stack([out[..., 0] * (1.0 + 2.0 ** -8), out[..., 1]], -1)

    monkeypatch.setattr(tdigest, "row_merge", drifted)
    out = run_small("default.feed")
    assert out["correct"] is False and out["checks"]["digest_gap"]["value"] == 0
    assert out["checks"]["digest_rank_gap"]["value"] > out["checks"]["digest_rank_gap"]["limit"]
