"""Feed entry ``columns``: ``store.agg.ingest(SpanColumns)``, the
aggregation tier's device feed as the fan-out tier's dispatcher hands it
to the card once the wire is parsed. The traffic's names are interned
through the store's vocabulary once at set-up; each batch is then the
pool batch's columns, re-stamped, with the store's ids."""

from __future__ import annotations

import numpy as np

from portbench.generator import Pool, service_name, span_name


def intern_names(vocab, mix: dict):
    """(svc_map, key_map): the store's ids of the traffic's services and
    sketch keys, interned into the store's vocabulary ``vocab`` as a warm
    server holds them."""
    services, names = int(mix["services"]), int(mix["names_per_service"])
    svc_map = np.zeros(services + 1, np.int32)
    key_map = np.zeros((services + 1) * names, np.int32)
    name_ids = [vocab.span_names.intern(span_name(n)) for n in range(names)]
    for s in range(1, services + 1):
        sid = vocab.services.intern(service_name(s))
        svc_map[s] = sid
        for n, nid in enumerate(name_ids):
            key_map[s * names + n] = vocab.key_id(sid, nid)
    if not (svc_map[1:] > 0).all() or len(set(key_map[names:].tolist())) != services * names:
        raise ValueError("the configuration's vocabulary cannot hold the traffic's names")
    return svc_map, key_map


class Entry:
    def __init__(self, store, pool: Pool):
        from zipkin_tpu_torch.tpu.columnar import SpanColumns

        self._cols = SpanColumns
        self.store = store
        self.pool = pool
        self.svc_map, self.key_map = intern_names(store.vocab, pool.mix)
        self._mapped = [(self.svc_map[b.cols["svc"]], self.svc_map[b.cols["rsvc"]],
                         self.key_map[b.cols["key"]]) for b in pool.batches]

    def inputs(self, g: int):
        """Global batch ``g`` as the store's host columns."""
        c = self.pool.columns(g)
        svc, rsvc, key = self._mapped[g % self.pool.size]
        return self._cols(
            trace_h=c["trace_h"], tl0=c["tl0"], tl1=c["tl1"], s0=c["s0"], s1=c["s1"],
            p0=c["p0"], p1=c["p1"], shared=c["shared"], kind=c["kind"], svc=svc, rsvc=rsvc,
            key=key, err=c["err"], dur=c["dur"], has_dur=c["has_dur"], ts_min=c["ts_min"],
            valid=c["valid"])

    def __call__(self, cols) -> None:
        self.store.agg.ingest(cols)
