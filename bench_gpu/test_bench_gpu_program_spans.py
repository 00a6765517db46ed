"""The readers of the port's own spans and counters (``request_log.py``
and ``metrics/{gc_pause_ms, reply_objects_ms, card_wait_ms,
drain_host_ms, whole_batch_pct}.py``) on requests served on the CPU: a
window the port's ring holds reads its records, one it does not hold
gives None."""

from __future__ import annotations

import numpy as np
import pytest

from bench_gpu import request_log, run, spec
from bench_gpu.record import Run
from redis_hnsw_tpu_torch import HNSW
from redis_hnsw_tpu_torch.ops import scan
from redis_hnsw_tpu_torch.utils import profiling

NEW = ("gc_pause_ms", "reply_objects_ms", "card_wait_ms", "drain_host_ms",
       "whole_batch_pct")


def window_of(requests: int, queries: int) -> Run:
    return Run(setup_s=1.0, window_s=1.0, latencies_s=[0.01] * requests,
               answered_queries=requests * queries, live_rows=500,
               mem_peak_bytes=None)


def readings(r: Run) -> dict:
    metrics = [m for m in spec.load_benchmark()["per_layer"]
               if m["name"] in NEW]
    assert len(metrics) == len(NEW)
    return {k: v["value"] for k, v in run.read_metrics(metrics, r).items()}


@pytest.fixture
def served(monkeypatch):
    """Six certified requests of 40 queries on a flat index of 4,096 rows
    (32 of the one-pass form's bins), the last on rows of a tie class cut
    at k (rerun whole); returns their records."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setattr(scan, "CERT_AUDIT_EVERY", 0)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((6, 8)).astype(np.float32)
    data = np.concatenate([rng.standard_normal((4036, 8)),
                           np.repeat(base, 10, axis=0)]).astype(np.float32)
    client = HNSW(device="cpu")
    client.create_index("i", dim=8, kind="flat")
    client.add_batch("i", [f"r{j}" for j in range(len(data))], data)
    for _ in range(5):
        client.search_batch("i", rng.standard_normal((40, 8)), k=2)
    client.search_batch("i", np.repeat(base, 7, axis=0)[:40], k=5)
    return profiling.recent(6)


def test_a_window_the_ring_holds(served):
    got = readings(window_of(6, 40))
    assert set(got) == set(NEW)
    assert got["gc_pause_ms"] == pytest.approx(
        1e-6 * served["gc_ns"].mean())
    assert got["reply_objects_ms"] == pytest.approx(1e-6 * (
        served["assemble_ns"] - served["gc_in_assemble_ns"]).mean())
    assert got["card_wait_ms"] == pytest.approx(
        1e-6 * served["card_wait_ns"].mean())
    assert got["drain_host_ms"] == pytest.approx(1e-6 * (
        served["dispatch_ns"] + served["finish_ns"]
        + served["rerun_ns"]).mean())
    assert got["drain_host_ms"] > 0 and got["reply_objects_ms"] > 0
    assert got["whole_batch_pct"] == pytest.approx(100 / 6)


def test_a_window_the_ring_does_not_hold(served):
    assert readings(window_of(profiling.RING_ROWS + 1, 40)) == {}
    # the newest records are not the window's: their queries disagree
    assert readings(window_of(6, 41)) == {}
    assert request_log.window(window_of(0, 40)) is None


def test_profiled_requests_are_left_out(served, monkeypatch):
    log = dict(served)
    log["profiled"] = np.array([1, 1, 1, 1, 1, 0])
    monkeypatch.setattr(profiling, "recent", lambda n: log)
    got = request_log.window(window_of(6, 40))
    assert got["whole_batch_queries"].tolist() == [40]
    log["profiled"] = np.ones(6, np.int64)
    assert readings(window_of(6, 40)) == {}


def test_a_program_without_the_log_gives_none(monkeypatch):
    monkeypatch.delattr(profiling, "recent")
    assert request_log.window(window_of(3, 10)) is None
