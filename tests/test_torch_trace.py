"""The port's tracing on the CPU (redis_hnsw_tpu_torch/utils/profiling.py):
the per-request record that every ``HNSW.search_batch`` writes into the
ring, the spans and counters of the serving path that fill it, the
collector hook, the ring's wrap, that the recorder leaves nothing for
the collector to walk, and the ``hnsw.*`` profiler annotations."""

import gc
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T
import redis_hnsw_tpu_torch.ops.scan as TS
import redis_hnsw_tpu_torch.ops.search as TSE
from redis_hnsw_tpu_torch.utils import profiling as P

SPANS = ("lock_wait_ns", "prepare_ns", "dispatch_ns", "card_wait_ns",
         "finish_ns", "rerun_ns", "assemble_ns")


def gauss(rng, n, dim):
    return rng.standard_normal((n, dim)).astype(np.float32)


def flat_client(rng, name="f", n=600, dim=16, data=None):
    client = T.HNSW(device="cpu")
    client.create_index(name, dim=dim, kind="flat")
    data = gauss(rng, n, dim) if data is None else data
    client.add_batch(name, [f"{name}{i}" for i in range(len(data))], data)
    return client


def last(n=1):
    """The newest ``n`` records, one dict of ints each, oldest first."""
    log = P.recent(n)
    return [{f: int(log[f][i]) for f in P.FIELDS}
            for i in range(len(log["queries"]))]


def test_one_record_per_search_batch_a_failed_one_included(rng):
    client = flat_client(rng)
    client.search_batch("f", gauss(rng, 3, 16), k=4)
    client.search_batch("f", gauss(rng, 7, 16), k=4)
    with pytest.raises(T.HNSWError):
        client.search_batch("f", gauss(rng, 2, 9), k=4)  # wrong width
    with pytest.raises(T.HNSWError):
        client.search_batch("none", gauss(rng, 2, 16), k=4)
    recs = last(4)
    assert [r["queries"] for r in recs] == [3, 7, 0, 0]
    assert [r["failed"] for r in recs] == [0, 0, 1, 1]
    assert [r["chunks"] for r in recs] == [1, 1, 0, 0]
    assert all(r["request_ns"] > 0 and r["profiled"] == 0 for r in recs)
    assert recs[0]["start_ns"] < recs[1]["start_ns"] < recs[3]["start_ns"]
    got = client.request_log(4)
    assert list(got) == list(P.FIELDS)
    assert got["queries"].tolist() == [3, 7, 0, 0]


def test_spans_sum_to_no_more_than_the_request(rng, monkeypatch):
    monkeypatch.setattr(TSE, "MAX_LANES", 64)
    client = flat_client(rng)
    client.search_batch("f", gauss(rng, 200, 16), k=5)
    (rec,) = last()
    assert rec["chunks"] == 4
    assert sum(rec[f] for f in SPANS) <= rec["request_ns"]
    for f in ("prepare_ns", "dispatch_ns", "finish_ns", "assemble_ns"):
        assert rec[f] > 0, f


def test_a_span_counts_its_self_time():
    """Time in a span opened inside another is taken off the outer one."""
    outer, inner = P.span("test_outer"), P.span("test_inner")
    before = P.totals()
    with outer:
        with inner:
            t = time.perf_counter_ns()
            while time.perf_counter_ns() - t < 2_000_000:
                pass
    after = P.totals()
    own = {n: after[n][0] - before.get(n, (0, 0))[0]
           for n in ("test_outer", "test_inner")}
    assert own["test_inner"] >= 2_000_000
    assert own["test_outer"] < own["test_inner"]
    assert after["test_outer"][1] == before.get("test_outer", (0, 0))[1] + 1


def test_chunks_and_queries_of_a_5000_query_block(rng):
    client = flat_client(rng, n=300, dim=8)
    reply = client.search_batch("f", gauss(rng, 5000, 8), k=3)
    assert len(reply) == 5000
    (rec,) = last()
    assert (rec["queries"], rec["chunks"]) == (5000, 3)  # MAX_LANES 2048
    assert rec["failed"] == 0


def test_a_collection_lands_in_its_own_threads_record(rng, monkeypatch):
    """Two threads on two indexes: a gc.collect() inside thread a's
    assemble span goes to a's record (all of it inside assemble) and
    none to b's, whose request is open meanwhile."""
    client = flat_client(rng, "a")
    client.create_index("b", dim=16, kind="flat")
    client.add_batch("b", [f"b{i}" for i in range(300)], gauss(rng, 300, 16))
    client.search_batch("a", gauss(rng, 2, 16), k=3)  # the hook is in
    real = TSE.assemble
    b_open, a_done = threading.Event(), threading.Event()

    def assemble(names, ids, sims, reply):
        if threading.current_thread().name == "a":
            assert b_open.wait(30)
            with P.span("assemble"):
                gc.collect()
            a_done.set()
        else:
            b_open.set()
            assert a_done.wait(30)
        return real(names, ids, sims, reply)

    monkeypatch.setattr(TSE, "assemble", assemble)
    recs, errors = {}, []

    def run(name, n_q):
        try:
            client.search_batch(name, gauss(np.random.default_rng(1), n_q,
                                            16), k=3)
            recs[name] = last()[0]
        except Exception as e:  # reported below
            errors.append(repr(e))

    full = P.gc_totals()["count"][2]
    threads = [threading.Thread(target=run, args=(n, q), name=n)
               for n, q in (("a", 5), ("b", 9))]
    gc.disable()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        gc.enable()
    assert not any(t.is_alive() for t in threads) and errors == []
    a, b = (rec for _, rec in sorted(recs.items()))
    assert (a["queries"], b["queries"]) == (5, 9)
    assert a["gc_ns"] > 0 and a["gc_count"] >= 1 and a["gc_full"] >= 1
    assert a["gc_in_assemble_ns"] == a["gc_ns"]
    assert (b["gc_ns"], b["gc_count"], b["gc_full"]) == (0, 0, 0)
    assert P.gc_totals()["count"][2] >= full + 1


def tie_heavy(rng):
    """Every row 8 times over, queries on the rows: a k = 12 cut splits a
    tie class on every query, so no query certifies."""
    base = gauss(rng, 40, 24)
    return np.repeat(base, 8, axis=0), np.repeat(base[:10], 13, axis=0)


@pytest.mark.parametrize("case", ["tie-heavy", "random", "audit", "skipped"])
def test_fallback_counters(rng, monkeypatch, case):
    """The certified tier's reruns, counted apart in CERT_STATS and the
    request's record: a tie-heavy batch rerun whole, a few spurious
    uncertified rows of random data deferred to the rerun sink, an
    audited batch; and the next request on the tie-heavy table, whose
    five chunks its failing certificate leaves to the exact tier
    (``cert_skipped_queries``, CERT_STATS ``skipped_queries``), summed
    over the chunks."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setattr(TS, "CERT_AUDIT_EVERY", 1 if case == "audit" else 0)
    if case in ("tie-heavy", "skipped"):
        data, qs, k = *tie_heavy(rng), 12
    else:
        data, qs, k = gauss(rng, 300, 24), gauss(rng, 128, 24), 5
    if case == "random":
        real_cert = TS.scan_certified_l2

        def spoiled(vecs, sqn, live, qd, *, k):
            ids, sims, ok = real_cert(vecs, sqn, live, qd, k=k)
            ok = ok.clone()
            ok[::17] = False  # 8 spurious rows of 128
            return ids, sims, ok

        monkeypatch.setattr(TS, "scan_certified_l2", spoiled)
    client = flat_client(rng, dim=24, data=data)
    if case == "skipped":
        client.search_batch("f", qs, k=k)  # falls back whole: it fails
        monkeypatch.setattr(TSE, "MAX_LANES", 32)
    before = dict(TS.CERT_STATS)
    client.search_batch("f", qs, k=k)
    (rec,) = last()
    n_q = len(qs)
    cert = 0 if case == "skipped" else n_q
    want = {"whole_batch_queries": n_q if case == "tie-heavy" else 0,
            "rerun_queries": 8 if case == "random" else 0,
            "audit_queries": n_q if case == "audit" else 0}
    assert rec["cert_queries"] == cert
    assert TS.CERT_STATS["queries"] - before["queries"] == cert
    for key, n in want.items():
        assert rec[key] == n, key
        assert TS.CERT_STATS[key] - before[key] == n, key
    skipped = n_q - cert
    assert rec["cert_skipped_queries"] == skipped
    assert (TS.CERT_STATS["skipped_queries"]
            - before["skipped_queries"]) == skipped
    assert rec["chunks"] == (5 if case == "skipped" else 1)
    fallback = TS.CERT_STATS["fallback_queries"] - before["fallback_queries"]
    assert fallback == {"tie-heavy": n_q, "random": 8, "audit": 0,
                        "skipped": 0}[case]


def test_the_ring_wraps_at_capacity():
    n = P.RING_ROWS + 5
    for i in range(n):
        with P.request():
            P.count("queries", i)
    log = P.recent(P.RING_ROWS + 100)
    assert len(log["queries"]) == P.RING_ROWS
    assert log["queries"].tolist() == list(range(5, n))
    assert P.recent(3)["queries"].tolist() == [n - 3, n - 2, n - 1]
    assert len(P.recent(0)["queries"]) == 0


def test_records_of_many_threads_stay_apart():
    """More threads than cores, switching every microsecond: each
    thread's records hold only its own counts and spans, none is lost."""
    n_threads, n_req = 12, 200
    before = P.totals().get("test_stress", (0, 0))[1]
    errors = []

    def work(i):
        try:
            for _ in range(n_req):
                with P.request():
                    with P.span("test_stress"):
                        P.count("queries", i)
                    P.count("chunks", 1)
        except Exception as e:  # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i + 1,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    log = P.recent(n_threads * n_req)
    assert sorted(np.bincount(log["queries"]).tolist()[1:]) == (
        [n_req] * n_threads)
    assert (log["chunks"] == 1).all() and (log["failed"] == 0).all()
    assert P.totals()["test_stress"][1] == before + n_threads * n_req


def test_the_recorder_leaves_no_objects_to_collect(rng):
    """50 requests add no object that the collector tracks: the record is
    a list made once a thread, the ring a preallocated array."""
    client = flat_client(rng)
    qs = gauss(rng, 40, 16)
    for _ in range(5):
        client.search_batch("f", qs, k=4)
    # a collection untracks a tuple only once every tuple in it is
    # untracked, in list order: the nested constants of modules the first
    # requests imported can take a few full collections to settle
    for _ in range(3):
        gc.collect()
    n0 = len(gc.get_objects())
    for _ in range(50):
        client.search_batch("f", qs, k=4)
    gc.collect()
    assert len(gc.get_objects()) == n0
    assert last(50)[0]["queries"] == 40


def test_build_phases_in_the_registry(rng):
    """A bulk build's phases are host spans in the registry."""
    before = P.totals()
    idx = T.HNSWIndex("h", T.IndexConfig(dim=8, m=4, ef_construction=16,
                                         seed=3), device="cpu")
    idx.add_batch([f"n{i}" for i in range(64)], gauss(rng, 64, 8),
                  batch_size=32)
    after = P.totals()
    for name in ("snapshot_refresh", "device_pass", "fetch_results",
                 "host_surgery"):
        assert after[name][1] > before.get(name, (0, 0))[1], name


def test_annotations_only_while_the_profiler_records(rng, tmp_path,
                                                     monkeypatch):
    client = flat_client(rng)
    qs = gauss(rng, 30, 16)
    client.search_batch("f", qs, k=4)
    with P.device_trace(str(tmp_path), device="cpu") as prof:
        client.search_batch("f", qs, k=4)
        gc.collect()
    assert last()[0]["profiled"] == 1
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for label in ("request", "lock_wait", "prepare", "dispatch", "finish",
                  "rerun", "assemble", "gc.2"):
        assert "hnsw." + label in names, label
    made = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        made.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    client.search_batch("f", qs, k=4)
    gc.collect()
    assert made == []
    assert last()[0]["profiled"] == 0
