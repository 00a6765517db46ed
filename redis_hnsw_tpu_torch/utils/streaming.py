"""Streaming mixed insert+query workloads (BASELINE.json config 4).

Port of ``redis_hnsw_tpu/utils/streaming.py``. The reference serializes
every command under Redis's event loop, so a "concurrent" 50/50
insert+query mix is an interleaved sequential stream (src/lib.rs:349,
:474 error on lock contention rather than overlap). Here the stream
interleaves *batched* phases: an insert wave (device-scored bulk
construction, ops/construct.py) and a query batch (ops/search.py), with
the device snapshot refreshed incrementally between phases
(ops/snapshot.py delta path).

Two interleave shapes:

* serial (default) -- insert wave, then query batch, strictly
  alternating. Query batches see every preceding insert (the
  reference's visibility), and the wave's whole latency (device pass,
  host surgery, snapshot delta) sits between query batches, so query
  p95 tracks the wave's wall time.
* overlap=True -- each wave is sliced into ``slices`` sub-waves, and
  query batches are served BEFORE the wave's sub-waves, against the
  bounded-stale device view (search_batch staleness=wave; see
  models/hnsw.py device_snapshot): a query waits for its own scan, not
  for the wave's dirty-row delta or device pass, and sees the state as
  of the previous completed wave -- one wave staler than serial.
  Sub-waves still serialize beam -> surgery -> beam, so the graph is
  IDENTICAL to add_batch at batch_size = wave/slices. Query batches stay
  full width (``query_batch``); an owed-queries counter keeps the 50/50
  count at any query_batch/insert_wave ratio.

The harness reports sustained throughput, per-phase latency percentiles
and maxima, and a wall-clock decomposition (insert / query / validate /
other), so a stall outside the timed phases shows.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class MixedStats:
    """Outcome of one run_mixed stream."""

    inserts: int
    queries: int
    elapsed_s: float
    inserts_per_s: float
    qps: float
    insert_ms: list[float]          # per insert-phase latency
    query_ms: list[float]           # per query-phase latency
    insert_total_s: float = 0.0
    query_total_s: float = 0.0
    validate_total_s: float = 0.0
    other_total_s: float = 0.0

    def percentile(self, series: str, p: float) -> float:
        data = getattr(self, series)
        return float(np.percentile(data, p)) if data else 0.0

    def steady(self) -> dict:
        """Sustained rate with compile-spike waves excluded.

        A first wave can pay one-time costs (the kernels' build, the
        first snapshot's upload) that are not the serving-regime rate.
        A wave is such a spike when it exceeds max(10 x median wave,
        30s); both the raw sustained rate and this steady rate are
        reported so neither hides the other.
        """
        ins = np.asarray(self.insert_ms, dtype=np.float64) / 1e3
        if not len(ins):
            return {}
        thr = max(10.0 * float(np.median(ins)), 30.0)
        spike = ins > thr
        n_spike = int(spike.sum())
        spike_s = float(ins[spike].sum())
        per_wave = self.inserts / len(ins)
        steady_inserts = self.inserts - n_spike * per_wave
        steady_elapsed = max(self.elapsed_s - spike_s, 1e-9)
        return {
            "inserts_per_s_steady": round(steady_inserts / steady_elapsed, 1),
            "compile_spike_waves": n_spike,
            "compile_spike_s": round(spike_s, 1),
        }

    def summary(self) -> dict:
        return {
            "inserts": self.inserts,
            "queries": self.queries,
            "elapsed_s": round(self.elapsed_s, 3),
            "inserts_per_s": round(self.inserts_per_s, 1),
            **self.steady(),
            "qps": round(self.qps, 1),
            "insert_p50_ms": round(self.percentile("insert_ms", 50), 2),
            "insert_p95_ms": round(self.percentile("insert_ms", 95), 2),
            "query_p50_ms": round(self.percentile("query_ms", 50), 2),
            "query_p95_ms": round(self.percentile("query_ms", 95), 2),
            "insert_max_ms": round(max(self.insert_ms, default=0.0), 1),
            "query_max_ms": round(max(self.query_ms, default=0.0), 1),
            "insert_total_s": round(self.insert_total_s, 1),
            "query_total_s": round(self.query_total_s, 1),
            "validate_total_s": round(self.validate_total_s, 1),
            "other_total_s": round(self.other_total_s, 1),
        }


def _device_query_batches(q_pool: np.ndarray, chunk: int, device):
    """Upload the query pool ONCE, with ``torch.as_tensor`` onto the
    index's device, and serve per-phase batches as slices of it. None
    (the host path) when the pool does not divide evenly, or is not
    float32 (packed hamming words go through search_batch's own
    conversion)."""
    if chunk <= 0 or q_pool.shape[0] % chunk or q_pool.dtype != np.float32:
        return None
    import torch

    pool_dev = torch.as_tensor(q_pool, device=device)
    return [
        pool_dev[i:i + chunk]
        for i in range(0, q_pool.shape[0], chunk)
    ]


def run_mixed(
    index,
    names,
    data,
    queries,
    k: int = 10,
    insert_wave: int = 256,
    query_batch: int = 256,
    ef_search: int | None = None,
    expand: int = 1,
    iters: int | None = None,
    validate_every: int = 0,
    capacity_hint: int | None = None,
    engine: str = "auto",
    overlap: bool = False,
    slices: int = 1,
    progress=None,
) -> MixedStats:
    """Interleave insert waves and query batches 50/50 until ``data`` is
    exhausted; queries cycle through ``queries``.

    Serial mode: each query batch runs against the index state as of
    the preceding insert wave (the reference's serialized interleave
    gives the same visibility). ``overlap=True``: full-width query
    batches dispatch BEFORE each wave's sub-waves against the
    bounded-stale view, count parity kept by an owed-queries counter
    (see module docstring for the visibility/latency trade).

    ``validate_every`` > 0 asserts every Nth query batch returns the
    freshly-inserted wave's own vectors as top-1 self-hits (sanity that
    search really sees the new writes).

    ``engine`` picks the serving engine for the stream's query batches
    (ops/search.py search_batch). The default "auto" routes to the
    exact scan below the crossover (<= 2^21 padded rows), which serves
    every query at recall 1.0; pass "graph" to exercise the traversal
    under mutation instead.
    """
    data = np.atleast_2d(np.asarray(data, dtype=index._vectors.dtype))
    n_total = data.shape[0]
    # presize device tables for the whole stream: without this, every
    # power-of-two growth of the snapshot is a full rebuild mid-stream
    index._capacity_hint = max(
        int(getattr(index, "_capacity_hint", 0)),
        capacity_hint
        if capacity_hint is not None
        else index._names.high_water + n_total,
    )
    q_pool = np.atleast_2d(np.asarray(queries, dtype=data.dtype))
    slices = max(1, int(slices))
    q_chunk = query_batch
    dev_batches = _device_query_batches(q_pool, q_chunk, index.device)
    insert_ms: list[float] = []
    query_ms: list[float] = []
    t_ins = t_q = t_val = 0.0
    n_queries = 0
    q_i = 0
    phase = 0

    def next_batch():
        nonlocal q_i
        if dev_batches is not None:
            qb = dev_batches[q_i % len(dev_batches)]
        else:
            qb = np.take(
                q_pool,
                range(q_i * q_chunk, (q_i + 1) * q_chunk),
                axis=0,
                mode="wrap",
            )
        q_i += 1
        return qb

    def serve(qb, staleness: int = 0):
        nonlocal n_queries, t_q
        t0 = time.perf_counter()
        res = index.search_batch(
            qb, k, ef_search=ef_search, expand=expand, iters=iters,
            engine=engine, staleness=staleness,
        )
        dt = time.perf_counter() - t0
        query_ms.append(dt * 1e3)
        t_q += dt
        n_queries += len(res)

    def validate(lo, hi):
        nonlocal t_val
        t0 = time.perf_counter()
        # Visibility probe on the SERVING path: an exact-scan self-query
        # must return itself top-1 (sim 0 is the unique max up to exact
        # duplicates -- one miss allowed). Plus a host-side linkage
        # invariant: every probed row has layer-0 neighbors -- stronger
        # graph evidence than a beam self-hit (which can succeed through
        # the entrypoint alone) at O(1) host cost.
        probe_n = min(8, hi - lo)
        self_res = index.search_batch(
            data[lo:hi][:probe_n], 1, engine="scan",
        )
        hits = sum(
            1
            for i, r in enumerate(self_res)
            if r and r[0].name == names[lo + i]
        )
        assert hits >= probe_n - 1, (
            f"stream visibility: only {hits}/{probe_n} self-hits after "
            f"wave at {lo}"
        )
        if index.node_count > 1:
            for i in range(probe_n):
                row = index._names.get(names[lo + i])
                assert row is not None and index._nbrs(row, 0), (
                    f"stream linkage: row for {names[lo + i]} has no "
                    f"layer-0 neighbors after wave at {lo}"
                )
        t_val += time.perf_counter() - t0

    if overlap:
        from ..ops import construct as C

        ef_con = index.config.ef_construction

    t_start = time.perf_counter()
    q_owed = 0  # queries owed to keep the 50/50 count at any q_chunk
    for lo in range(0, n_total, insert_wave):
        hi = min(lo + insert_wave, n_total)
        if not overlap:
            t0 = time.perf_counter()
            index.add_batch(
                names[lo:hi], data[lo:hi], batch_size=insert_wave
            )
            dt = time.perf_counter() - t0
            insert_ms.append(dt * 1e3)
            t_ins += dt
            serve(next_batch())
        else:
            # Serve FIRST, against the bounded-stale device view: the
            # query waits only for its own scan -- never the wave's
            # dirty-row delta nor its device pass. Staleness bound =
            # one wave (epochs bump at most once per insert).
            # Full-width batches: the owed counter keeps queries ==
            # inserts at any q_chunk.
            q_owed += hi - lo
            while q_owed >= q_chunk:
                serve(next_batch(), staleness=insert_wave)
                q_owed -= q_chunk
            step = max(1, (hi - lo + slices - 1) // slices)
            for sl in range(lo, hi, step):
                sh = min(sl + step, hi)
                t0 = time.perf_counter()
                if index.node_count == 0:
                    # seed node: the wave machinery needs an enterpoint
                    index.add_node(names[sl], data[sl])
                    wave = C.dispatch_wave(
                        index, names[sl + 1:sh], data[sl + 1:sh],
                        ef_con,
                    ) if sh - sl > 1 else None
                else:
                    wave = C.dispatch_wave(
                        index, names[sl:sh], data[sl:sh], ef_con
                    )
                if wave is not None:
                    C.complete_wave(index, wave)
                dt = time.perf_counter() - t0
                insert_ms.append(dt * 1e3)
                t_ins += dt

        phase += 1
        if validate_every and phase % validate_every == 0:
            validate(lo, hi)
        if progress is not None:
            # hook for harness-level liveness logging: (wave phase,
            # rows inserted so far, wall so far)
            progress(phase, hi, time.perf_counter() - t_start)

    elapsed = time.perf_counter() - t_start
    return MixedStats(
        inserts=n_total,
        queries=n_queries,
        elapsed_s=elapsed,
        inserts_per_s=n_total / elapsed,
        qps=n_queries / elapsed,
        insert_ms=insert_ms,
        query_ms=query_ms,
        insert_total_s=t_ins,
        query_total_s=t_q,
        validate_total_s=t_val,
        other_total_s=elapsed - t_ins - t_q - t_val,
    )
