"""A whole run of a cell on the CPU at a tiny size: the result line, the
control coming out not correct, and the timed path broken underneath
coming out not correct. The harness's look for a card is skipped by
calling ``run_cell`` with ``device="cpu"``; everything after it is the
run as the card sees it."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from bench_gpu import control, run, spec
from bench_gpu.loops import closed
from bench_gpu.record import Run, TraceData
from bench_gpu.trace import Tracer
from redis_hnsw_tpu_torch.models import flat
from redis_hnsw_tpu_torch.ops import distance, scan

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(name: str, rows: int = 6000) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, rows=rows)
    cell.traffic = dict(cell.traffic, request_queries=300,
                        pool_rate_per_s=60, check_per_request=16)
    return cell


def go(cell, trace=False, seed=2**31 + 11, seconds=1.0):
    return run.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                        device="cpu")


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_untraced_run_line(name):
    cell = tiny(name)
    result, lines = go(cell)
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] > 0
    want = {m["name"] for m in cell.end_to_end}
    # the card's memory peak is not read on the CPU
    assert set(result["metrics"]) == want - {"mem_bytes_per_row"}
    for m in cell.end_to_end:
        if m["name"] in result["metrics"]:
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
            assert result["metrics"][m["name"]]["value"] > 0
    assert list(result["checks"]) == ["bad_answers", "sim_err", "rank_gap"]
    for name_, c in result["checks"].items():
        assert lines[-3:][list(result["checks"]).index(name_)].startswith(
            f"check {name_}: ")
        assert c["value"] <= c["limit"]
    json.dumps(result)


def test_traced_run_line():
    cell = tiny("sift128.batch")
    result, lines = go(cell, trace=True, seconds=2.0)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert result["correct"] is True, lines
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for part in result["breakdown"].values():
        assert len(part) <= 10
    # no card: no device metric, and the program's own readings remain
    assert "device_idle_pct" not in result["metrics"]
    assert "kernels_roofline" not in result["metrics"]
    assert result["metrics"]["table_bytes_per_row"]["value"] > 512
    assert result["metrics"]["reply_ms"]["value"] > 0
    assert all(p not in result["metrics"]
               for p in ("qps", "p95_ms", "setup_s"))


def test_a_traced_run_with_launches_outside_the_entries_gives_no_result(
        monkeypatch):
    monkeypatch.setattr(TraceData, "unattributed_share", lambda self: 0.02)
    result, lines = go(tiny("sift128.batch"), trace=True, seconds=2.0)
    assert result is None
    assert any("outside the entries" in line for line in lines)
    monkeypatch.setattr(TraceData, "unattributed_share", lambda self: 0.005)
    result, _ = go(tiny("sift128.batch"), trace=True, seconds=2.0)
    assert result["correct"] is True


def test_pool_is_sized_to_the_window():
    mix = {"pool_rate_per_s": 12}
    assert run.pool_requests(mix, 40) == 480
    assert run.pool_requests(mix, 0.01) == 1
    assert run.pool_requests({"pool_rate_per_s": 2.5}, 3) == 8


def test_the_control_is_not_correct():
    for name in ("sift128.batch", "gist960.batch"):
        out = control.run_control(tiny(name), 7, 30, "cpu")
        assert out["correct"] is False, out
        assert out["checks"]["bad_answers"]["value"] == 0
    # the same answers at float64 are the reference's own: correct
    out = control.run_control(tiny("sift128.batch"), 7, 30, "cpu", "fp64")
    assert out["correct"] is True, out


def _stale(monkeypatch):
    """A search that returns its first reply again: state unchanged."""
    orig = flat.FlatIndex.search_batch
    first = []

    def search_batch(self, *a, **kw):
        out = orig(self, *a, **kw)
        if not first:
            first.append(out)
        return [list(r) for r in first[0]]

    monkeypatch.setattr(flat.FlatIndex, "search_batch", search_batch)


def _half(monkeypatch):
    """Half of each request served, the rest given the first half's
    answers."""
    orig = flat.FlatIndex.search_batch

    def search_batch(self, queries, k, **kw):
        h = (len(queries) + 1) // 2
        out = orig(self, queries[:h], k, **kw)
        return out + [list(r) for r in out[: len(queries) - h]]

    monkeypatch.setattr(flat.FlatIndex, "search_batch", search_batch)


def _wrong_row(monkeypatch):
    """The select names another row where it is produced."""
    orig = scan.flat_topk

    def flat_topk(queries, vecs, sq_masked, qq, *, k):
        ids, sims = orig(queries, vecs, sq_masked, qq, k=k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % vecs.shape[0]
        return ids, sims

    monkeypatch.setattr(scan, "flat_topk", flat_topk)


def _wrong_sim(monkeypatch):
    """The exact rescore off by one part in 10^4 where it is produced."""
    orig = distance.exact_neg_sq_l2

    def exact_neg_sq_l2(q, vecs, ids, mask):
        return orig(q, vecs, ids, mask) * (1 + 1e-4)

    monkeypatch.setattr(distance, "exact_neg_sq_l2", exact_neg_sq_l2)


@pytest.mark.parametrize("fault", [_stale, _half, _wrong_row, _wrong_sim])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, lines = go(tiny("gist960.batch"), seconds=1.5)
    assert result["correct"] is False, lines


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is there: the run would start")
    rc = run.main(["--workload", "sift128.batch", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


class _Ev:
    def __init__(self, name, start, dur, cuda=False, corr=0):
        self._v = (name, start, dur, cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]


def test_trace_reduction():
    tracer = Tracer(spec.load_peaks(), bounds={})
    tracer.least_s = {"select_bins": 0.003}
    events = [
        _Ev("bench.window", 0, 1000),
        _Ev("bench.request", 0, 900),
        _Ev("bench.kernel.select_bins", 100, 50),
        _Ev("cudaLaunchKernel", 120, 5, corr=7),
        _Ev("cudaLaunchKernel", 300, 5, corr=8),
        _Ev("cudaLaunchKernel", 310, 5, corr=9),
        _Ev("bench.assemble", 600, 300),
        _Ev("void rht_select::select_bins_kernel<4>(float const*)", 200,
            400, cuda=True, corr=7),
        _Ev("void at::native::sort(...)", 500, 200, cuda=True, corr=8),
        # a port kernel whose launch ran in no wrapped entry
        _Ev("void rht_scan::scan_tile_kernel<4>(float const*)", 720, 80,
            cuda=True, corr=9),
        _Ev("bench.request", 150, 600, cuda=True),  # an annotation
    ]
    t = tracer._reduce(events)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(580e-9)        # 200..700, 720..800
    assert t.port_kernel_s == pytest.approx(480e-9)
    assert t.kernel_s == {"select_bins": pytest.approx(400e-9)}
    assert t.unattributed_s == pytest.approx(80e-9)
    assert list(t.unattributed) == [
        "void rht_scan::scan_tile_kernel<4>(float const*)"]
    assert t.unattributed_share() == pytest.approx(80 / 480)
    assert t.device_events == 3
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps["bench.kernel.select_bins | python"] == pytest.approx(
        200e-9)                                      # 0..200, mid 100
    assert gaps["bench.assemble | python"] == pytest.approx(
        220e-9)                                      # 700..720, 800..1000
    assert t.breakdown["device_ops"][0][1] == pytest.approx(400e-9)
    assert t.roofline_pct("select_bins") == pytest.approx(
        100 * 0.003 / 400e-9)


def test_readers_of_a_run():
    trace = TraceData(window_s=2.0, busy_s=1.5, device_events=10,
                      port_kernel_s=1.0, least_s={"scan_topk": 0.4,
                                                  "select_bins": 0.2},
                      kernel_s={"scan_topk": 0.5, "select_bins": 0.4},
                      spans_s={"assemble": [0.01, 0.03]})
    r = Run(setup_s=12.0, window_s=4.0, latencies_s=[0.1] * 19
            + [float("inf")], answered_queries=1900, live_rows=1000,
            mem_peak_bytes=2_000_000, table_bytes=517_000,
            counters={"cert_queries": 400, "cert_fallback_queries": 4,
                      "requests_unprofiled": 10},
            trace=trace)
    allm = {m["name"]: m for m in spec.load_benchmark()["end_to_end"]
            + spec.load_benchmark()["per_layer"]}
    got = {k: v["value"] for k, v in run.read_metrics(list(allm.values()),
                                                       r).items()}
    assert got["qps"] == pytest.approx(475.0)
    assert got["p95_ms"] == pytest.approx(100.0)
    assert got["mem_bytes_per_row"] == pytest.approx(2000.0)
    assert got["setup_s"] == 12.0
    assert got["kernels_roofline"] == pytest.approx(60.0)
    assert got["scan_topk_roofline"] == pytest.approx(80.0)
    assert got["select_bins_roofline"] == pytest.approx(50.0)
    assert got["device_idle_pct"] == pytest.approx(25.0)
    assert got["cert_fallback_pct"] == pytest.approx(1.0)
    assert got["reply_ms"] == pytest.approx(4.0)
    assert got["table_bytes_per_row"] == pytest.approx(517.0)
    r.latencies_s = [0.1] * 18 + [float("inf")] * 2
    assert run.read_metrics([allm["p95_ms"]], r)["p95_ms"]["value"] >= 1e9


def test_take_sample_reads_names_and_flags_form():
    res = [[types.SimpleNamespace(name=str(i * 10 + j), sim=-float(j))
            for j in range(3)] for i in range(5)]
    ids, sims, bad, whole = closed.take_sample(res, np.array([1, 4]), 3, 5)
    assert whole and not bad.any()
    assert ids.tolist() == [[10, 11, 12], [40, 41, 42]]
    res[4] = res[4][:2]
    ids, sims, bad, whole = closed.take_sample(res, np.array([1, 4]), 3, 5)
    assert not whole and bad.tolist() == [False, True]
    assert closed.take_sample(res[:4], np.array([1]), 3, 5)[2].all()
