"""The plain reference: what a store of the configuration must answer
after the first ``n`` batches of a run's stream, worked out in numpy from
the generator's own data and the configuration's stated rules.

The configuration fixes the rules (its ``agg_config``): a retention ring
of ``ring_capacity`` spans whose older half is linked and folded into
hourly link buckets once the lanes written since the last fold would pass
half the ring; ``link_buckets`` such buckets, ``hist_slices`` histogram
slices and ``time_buckets`` time-tier buckets, each a ring of epochs where
a newer epoch takes the slot of the one ``n`` slots older. A read over
``[lo, hi]`` minutes sees the unfolded ring spans in it and the live
buckets or slices whose epoch lies in it. Every batch of the stream is
``batch_spans`` spans of one minute, so these rules act on whole batches.

Every pool batch's aggregate (key counts, histogram cells, edges) is
computed once; an answer is the pool aggregates weighted by how often
each pool batch occurs in the batches the answer covers. Only the HLL
registers depend on the re-stamped ids, and
:meth:`Reference.replay` walks the stream batch by batch for them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

from portbench.generator import Pool
from portbench.reference.sketch import HIST_BUCKETS, hist_bucket, hll_bucket_rho

NEVER = np.iinfo(np.int64).max


class Reference:
    def __init__(self, pool: Pool, agg: dict):
        self.pool = pool
        self.agg = agg
        mix = pool.mix
        self.S = int(mix["services"])
        self.names = int(mix["names_per_service"])
        self.K = (self.S + 1) * self.names
        self.G = self.S + 1  # the global HLL row in this reference's layout
        self.B = pool.batch_spans
        self.P = pool.size
        self.m = 1 << int(agg["hll_precision"])
        r = int(agg["ring_capacity"])
        if r % self.B or (r // 2) % self.B:
            raise ValueError("the ring and its half must hold whole batches")
        self.blocks = r // self.B
        self.half = self.blocks // 2

        s1 = self.S + 1
        self.key_counts = np.zeros((self.P, self.K), np.int64)
        self.err_counts = np.zeros(self.P, np.int64)
        self.edge_calls = np.zeros((self.P, s1 * s1), np.int64)
        self.edge_errs = np.zeros((self.P, s1 * s1), np.int64)
        self.hist_cells: List[tuple] = []
        for j, b in enumerate(pool.batches):
            c = b.cols
            hd = c["valid"] & c["has_dur"]
            self.key_counts[j] = np.bincount(c["key"][hd], minlength=self.K)
            self.err_counts[j] = int((c["valid"] & c["err"]).sum())
            cells, n_cell = np.unique(
                c["key"][hd].astype(np.int64) * HIST_BUCKETS + hist_bucket(c["dur"][hd]),
                return_counts=True)
            self.hist_cells.append((cells, n_cell))
            pair = (b.chain[:, :-1] * s1 + b.chain[:, 1:]).ravel()
            np.add.at(self.edge_calls[j], pair, 1)
            np.add.at(self.edge_errs[j], pair, b.hop_err.ravel().astype(np.int64))
        self.lane_key = [np.where(b.cols["valid"] & b.cols["has_dur"], b.cols["key"], -1)
                         .astype(np.int64) for b in pool.batches]

        self.lane_svc = [b.cols["svc"].astype(np.int64) for b in pool.batches]
        self.lane_trace = np.arange(self.B) // pool.per_trace
        # the fold schedule: the n from which each batch is folded
        self._rolled_at: List[int] = []
        self._ring = [-1] * self.blocks
        self._cursor = 0
        self._since_fold = 0

    # -- the stream's schedule ------------------------------------------------

    def minutes(self, n: int) -> np.ndarray:
        g = np.arange(n)
        return self.pool.base_minute + g // self.pool.batches_per_minute

    def rolled_at(self, n: int) -> np.ndarray:
        """[n] the batch count from which each of the first ``n`` batches
        is folded into the link buckets (NEVER: not yet)."""
        seg = self.blocks * self.B // 2
        while len(self._rolled_at) < n:
            g = len(self._rolled_at)
            if self._since_fold + self.B > seg:  # the older half is folded first
                for k in range(self.half):
                    b = self._ring[(self._cursor + k) % self.blocks]
                    if b >= 0 and self._rolled_at[b] == NEVER:
                        self._rolled_at[b] = g + 1
                self._since_fold = 0
            self._ring[self._cursor] = g
            self._rolled_at.append(NEVER)
            self._cursor = (self._cursor + 1) % self.blocks
            self._since_fold += self.B
        return np.asarray(self._rolled_at[:n], np.int64)

    def weights(self, batches: np.ndarray) -> np.ndarray:
        """[P] how often each pool batch occurs among ``batches``."""
        return np.bincount(np.asarray(batches, np.int64) % self.P, minlength=self.P)

    def _live(self, n: int, unit: int, slots: int, lo: int, hi: int) -> np.ndarray:
        """The batches below ``n`` whose epoch (minute // unit) is live in a
        ring of ``slots`` epochs and lies in ``[lo // unit, hi // unit]``."""
        ep = self.minutes(n) // unit
        if not n:
            return np.zeros(0, np.int64)
        sel = (ep > ep[-1] - slots) & (ep >= lo // unit) & (ep <= hi // unit)
        return np.nonzero(sel)[0]

    # -- answers at n -------------------------------------------------------

    def counters(self, n: int) -> Dict[str, int]:
        w = self.weights(np.arange(n))
        return {"spans": n * self.B, "spansWithDuration": n * self.B,
                "spansWithError": int(w @ self.err_counts), "batches": n}

    def key_total(self, n: int) -> np.ndarray:
        return self.weights(np.arange(n)) @ self.key_counts

    def hist(self, batches: np.ndarray) -> np.ndarray:
        """[K, HIST_BUCKETS] counts of ``batches``."""
        out = np.zeros(self.K * HIST_BUCKETS, np.int64)
        for j, w in enumerate(self.weights(batches)):
            if w:
                cells, n_cell = self.hist_cells[j]
                np.add.at(out, cells, w * n_cell)
        return out.reshape(self.K, HIST_BUCKETS)

    def window_batches(self, n: int, lo: int, hi: int) -> np.ndarray:
        """The batches a windowed histogram read over ``[lo, hi]`` sums."""
        a = self.agg
        return self._live(n, int(a["hist_slice_minutes"]), int(a["hist_slices"]), lo, hi)

    def window_counts(self, n: int, lo: int, hi: int) -> np.ndarray:
        return self.weights(self.window_batches(n, lo, hi)) @ self.key_counts

    def links(self, n: int, lo: int, hi: int):
        """([S+1, S+1] calls, errors) of a dependency read over minutes
        ``[lo, hi]``: the unfolded ring batches in the window and the live
        link buckets whose hour lies in it."""
        rolled = self.rolled_at(n) <= n
        mins = self.minutes(n)
        g = np.arange(n)
        fresh = g[~rolled & (mins >= lo) & (mins <= hi)]
        unit = int(self.agg["bucket_minutes"])
        folded = g[rolled]
        if len(folded):
            ep = mins[folded] // unit
            keep = (ep > ep.max() - int(self.agg["link_buckets"])) & (ep >= lo // unit) \
                & (ep <= hi // unit)
            folded = folded[keep]
        w = self.weights(np.concatenate([fresh, folded]))
        s1 = self.S + 1
        return (w @ self.edge_calls).reshape(s1, s1), (w @ self.edge_errs).reshape(s1, s1)

    def tt_batches(self, n: int, lo_ep: int, hi_ep: int) -> np.ndarray:
        """The batches a time-tier read over bucket epochs ``[lo_ep, hi_ep]``
        covers: those of live epochs in the range."""
        unit = int(self.agg["time_bucket_minutes"])
        return self._live(n, unit, int(self.agg["time_buckets"]), lo_ep * unit, hi_ep * unit)

    def tt(self, n: int, lo_ep: int, hi_ep: int):
        """(registers [S+2, m], key counts [K], calls, errors) of the time
        tier's buckets in ``[lo_ep, hi_ep]``."""
        batches = self.tt_batches(n, lo_ep, hi_ep)
        regs = np.zeros((self.S + 2) * self.m, np.uint8)
        for g in batches:
            self._raise(regs, int(g))
        w = self.weights(batches)
        s1 = self.S + 1
        return (regs.reshape(self.S + 2, self.m), w @ self.key_counts,
                (w @ self.edge_calls).reshape(s1, s1), (w @ self.edge_errs).reshape(s1, s1))

    # -- the walk over ids: HLL registers, verdicts, register traffic ---------

    def _targets(self, g: int):
        """(flat register index, rank) of batch ``g``'s register updates:
        each lane at its service's row, each trace at the global row."""
        bucket, rho = hll_bucket_rho(self.pool.trace_hashes(g), int(self.agg["hll_precision"]))
        t = self.lane_trace
        flat = np.concatenate([self.lane_svc[g % self.P] * self.m + bucket[t],
                               self.G * self.m + bucket])
        return flat, np.concatenate([rho[t], rho])

    def _raise(self, regs: np.ndarray, g: int) -> None:
        flat, rho = self._targets(g)
        np.maximum.at(regs, flat, rho)

    def replay(self, n: int, snapshots: Iterable[int] = (), traced: Iterable[int] = ()):
        """Walk batches ``0..n-1``: the HLL registers [S+2, m] after each of
        ``snapshots`` batch counts and after ``n``, and for each batch of ``traced`` the register words its
        step names and raises in the all-time file and in the time tier's."""
        want = sorted(set(int(s) for s in snapshots if 0 <= s <= n))
        traced = set(int(g) for g in traced)
        regs = np.zeros((self.S + 2) * self.m, np.uint8)
        tb = np.zeros_like(regs)
        tb_ep = None
        unit = int(self.agg["time_bucket_minutes"])
        mins = self.minutes(n)
        # the time tier's registers are followed from the epoch of the
        # first traced batch on (a new epoch starts from wiped registers)
        tb_from = int(mins[min(traced)]) // unit if traced else None
        snaps: Dict[int, np.ndarray] = {}
        traffic = {}
        k = 0
        for g in range(n):
            while k < len(want) and want[k] == g:
                snaps[g] = regs.reshape(self.S + 2, self.m).copy()
                k += 1
            flat, rho = self._targets(g)
            if g in traced:
                words = len(np.unique(flat // 4))
                written = len(np.unique(flat[rho > regs[flat]] // 4))
            ep = int(mins[g]) // unit
            if tb_from is not None and ep >= tb_from:
                if ep != tb_ep:
                    tb[:] = 0
                    tb_ep = ep
                if g in traced:
                    words += len(np.unique(flat // 4))
                    written += len(np.unique(flat[rho > tb[flat]] // 4))
                np.maximum.at(tb, flat, rho)
            if g in traced:
                traffic[g] = (words, written)
            np.maximum.at(regs, flat, rho)
        for s in want[k:]:
            snaps[s] = regs.reshape(self.S + 2, self.m).copy()
        return regs.reshape(self.S + 2, self.m), snaps, traffic
