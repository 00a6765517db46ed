"""Many single-query clients on one flat index, on the CPU at small sizes:
the replies of concurrent ``search_batch`` calls against the serial ones
and the benchmark's plain reference (``bench_gpu/reference/euclidean.py``),
the request record's ``lock_waiters`` and ``scan_lanes`` and the readers
of them, the loop ``loops/clients.py`` and a whole tiny run of the cell
``gist960.clients``. One test needs the card and skips without one:

    python -m pytest --noconftest -q tests/test_torch_bench_clients.py
"""

import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T
from bench_gpu import request_log, run, spec
from bench_gpu.loops import clients as loop_clients
from bench_gpu.loops import closed as loop_closed
from bench_gpu.record import Run
from bench_gpu.reference import euclidean as ref
from redis_hnsw_tpu_torch.ops import cuda_scan
from redis_hnsw_tpu_torch.utils import profiling as P

CELL = "gist960.clients"
CSRC = os.path.join(os.path.dirname(T.__file__), "csrc")
READERS = ("lock_wait_ms", "lock_waiters", "lane_fill_pct", "block_requests")
JOIN_S = 60.0


@pytest.fixture
def rng():
    """The seeded generator of tests/conftest.py, here too, so that the
    file also runs on a card's machine without that conftest."""
    return np.random.default_rng(0)


def flat_client(rng, n=1500, dim=24, device="cpu"):
    data = rng.standard_normal((n, dim)).astype(np.float32)
    client = T.HNSW(device=device)
    client.create_index("f", dim=dim, kind="flat")
    client.add_batch("f", [str(i) for i in range(n)], data)
    return client, data


def reply_rows(reply):
    ids = np.array([[int(r.name) for r in res] for res in reply])
    sims = np.array([[r.sim for r in res] for res in reply], np.float32)
    return ids, sims


def run_threads(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


def tiny(rows=3000, dim=48, **mix):
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, rows=rows, dim=dim,
                       generator=dict(cell.config["generator"], centres=32))
    cell.traffic = dict(cell.traffic, clients=6, pool_rate_per_s=400, **mix)
    return cell


# -- concurrent single-query replies ------------------------------------------

@pytest.mark.parametrize("dim,k", [(24, 1), (40, 10)])
def test_concurrent_replies_equal_serial_and_reference(rng, dim, k):
    """Eight threads, each sending its own queries one a call to one
    index: every reply is the serial reply for its query and names the
    reference's top k."""
    client, data = flat_client(rng, dim=dim)
    qs = rng.standard_normal((8, 12, dim)).astype(np.float32)
    serial = [[reply_rows(client.search_batch("f", q[None], k=k))
               for q in per] for per in qs]
    got = [[None] * qs.shape[1] for _ in range(len(qs))]

    def send(i):
        for j, q in enumerate(qs[i]):
            got[i][j] = reply_rows(client.search_batch("f", q[None], k=k))

    run_threads(send, len(qs))
    idx, _ = ref.knn(torch.from_numpy(data),
                     torch.from_numpy(qs.reshape(-1, dim)), k)
    want = idx.numpy().reshape(len(qs), qs.shape[1], k)
    for i in range(len(qs)):
        for j in range(qs.shape[1]):
            ids, sims = got[i][j]
            assert np.array_equal(ids, serial[i][j][0])
            assert np.array_equal(sims, serial[i][j][1])
            assert np.array_equal(ids[0], want[i, j])


# -- lock_waiters ---------------------------------------------------------------

def test_one_client_reads_no_waiters(rng):
    client, _ = flat_client(rng)
    for _ in range(3):
        client.search_batch("f", rng.standard_normal((1, 24)), k=3)
    log = client.request_log(3)
    assert log["lock_waiters"].tolist() == [0, 0, 0]
    assert log["queries"].tolist() == [1, 1, 1]


def wait_for(cond, what):
    t_end = time.monotonic() + JOIN_S
    while not cond():
        assert time.monotonic() < t_end, what
        time.sleep(0.001)


@pytest.mark.parametrize("holder,want", [("request", [0, 1, 2]),
                                         ("caller", [1, 2, 3])])
def test_queued_requests_count_those_ahead(rng, monkeypatch, holder, want):
    """Three requests queue on one index's lock, each started once the one
    before waits. Held by the first of them (blocked inside the index)
    they read 0, 1 and 2; held by a caller outside any request (as
    ``add_batch`` holds it) they read 1, 2 and 3: a holder counts."""
    client, _ = flat_client(rng)
    lock = client._index_locks["f"]
    index = client.index("f")
    release = threading.Event()
    if holder == "request":
        plain = index.search_batch

        def blocked(*a, **kw):
            release.wait(JOIN_S)
            return plain(*a, **kw)

        monkeypatch.setattr(index, "search_batch", blocked)
    else:
        lock.acquire()
    q = rng.standard_normal((1, 24)).astype(np.float32)
    base = 1 if holder == "caller" else 0
    threads = []
    for i in range(3):
        t = threading.Thread(target=client.search_batch, args=("f", q),
                             kwargs={"k": 2})
        t.start()
        threads.append(t)
        wait_for(lambda: lock._queued == base + i + 1,
                 f"request {i} never reached the lock")
    if holder == "caller":
        lock.release()
    release.set()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert lock._queued == 0
    assert sorted(client.request_log(3)["lock_waiters"].tolist()) == want


def test_waiter_count_stays_exact_under_contention(rng):
    """Eight threads, 25 single-query requests each, the interpreter
    switching threads every microsecond: no update of the count is lost
    (it returns to 0), and each request counts at most the seven others."""
    client, _ = flat_client(rng, n=300, dim=8)
    qs = rng.standard_normal((8, 25, 1, 8)).astype(np.float32)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_threads(lambda i: [client.search_batch("f", q, k=2)
                               for q in qs[i]], 8)
    finally:
        sys.setswitchinterval(saved)
    assert client._index_locks["f"]._queued == 0
    waiters = client.request_log(200)["lock_waiters"]
    assert len(waiters) == 200
    assert waiters.min() >= 0 and waiters.max() <= 7


# -- scan_lanes ---------------------------------------------------------------

@pytest.mark.parametrize("B,want", [(0, 0), (1, 128), (127, 128), (128, 128),
                                    (129, 256), (1000, 1024), (1024, 1024)])
def test_lane_arithmetic(B, want):
    for kernel in cuda_scan.QUERY_TILE:
        with P.request():
            cuda_scan.count_lanes(kernel, B)
            cuda_scan.count_lanes(kernel, B)
        assert P.recent(1)["scan_lanes"].tolist() == [2 * want]
    cuda_scan.count_lanes("scan_topk", B)   # no request open: no record
    assert P.recent(1)["scan_lanes"].tolist() == [2 * want]


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def constant(text, pattern):
    m = re.findall(pattern, text)
    assert len(m) == 1, pattern
    return int(m[0])


def wgmma_tile(cu, cwg_define):
    """A wgmma form's queries a block: hopper_ptx.cuh's Frame TILE_Q (a
    multiple of its consumer warpgroups) at the form's CWG."""
    per = constant(source("hopper_ptx.cuh"),
                   r"static constexpr int TILE_Q = (\d+) \* CWG;")
    text = source(cu)
    assert re.search(rf"using F = Frame<{cwg_define},", text)
    return per * constant(text, rf"#define {cwg_define} (\d+)")


def l2_tile():
    return constant(source("l2_core.cuh"), r"constexpr int TILE_Q = (\d+);")


# each kernel: its CUDA tile, and the source whose grid divides B by it
TILES = {
    "scan_topk": (l2_tile, "scan_topk.cu", "TILE_Q"),
    "scan_topk_hamming": (
        lambda: constant(source("hamming_mma.cuh"),
                         r"constexpr int TILE = (\d+);"),
        "scan_topk.cu", "TILE"),
    "scan_lowp": (lambda: constant(source("scan_lowp.cu"),
                                   r"constexpr int TILE = (\d+);"),
                  "scan_lowp.cu", "TILE"),
    "scan_bf16": (lambda: wgmma_tile("scan_bf16.cu", "RHT_BF16_CWG"),
                  "hopper_ptx.cuh", "F::TILE_Q"),
    "scan_int8": (lambda: wgmma_tile("scan_int8.cu", "RHT_INT8_CWG"),
                  "hopper_ptx.cuh", "F::TILE_Q"),
    "select_bins": (l2_tile, "select_bins.cu", "TILE_Q"),
    "count_gt_eq": (l2_tile, "count_gt_eq.cu", "TILE_Q"),
    "count_hamming": (lambda: constant(source("count_hamming.cu"),
                                       r"constexpr int QT = (\d+);"),
                      "count_hamming.cu", "QT"),
}


@pytest.mark.parametrize("kernel", sorted(TILES))
def test_query_tile_equals_the_cuda_constant(kernel):
    tile_of, grid_file, name = TILES[kernel]
    assert set(TILES) == set(cuda_scan.QUERY_TILE)
    assert cuda_scan.QUERY_TILE[kernel] == tile_of()
    assert f"grid((B + {name} - 1) / {name}" in source(grid_file)


def test_the_cpu_path_counts_no_lanes(rng):
    client, _ = flat_client(rng)
    client.search_batch("f", rng.standard_normal((5, 24)), k=3)
    assert client.request_log(1)["scan_lanes"].tolist() == [0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scan_lanes_on_the_card(card):
    """Kernel A computes whole 128-query tiles: one query a request
    records 128 lanes, 1,000 (padded to 1,024) record 1,024."""
    rng = np.random.default_rng(7)
    client, _ = flat_client(rng, n=5000, dim=128, device=card)
    for b, want in ((1, 128), (1000, 1024)):
        client.search_batch("f", rng.standard_normal((b, 128)), k=10)
        log = client.request_log(1)
        assert log["queries"].tolist() == [b]
        assert log["exact_queries"].tolist() == [b]
        assert log["scan_lanes"].tolist() == [want]


# -- the readers ----------------------------------------------------------------

def one_record(monkeypatch, drop=None, **counts):
    with P.request():
        for field, n in counts.items():
            P.count(field, n)
    log = P.recent(1)
    if drop is not None:
        log = {f: c for f, c in log.items() if f != drop}
    monkeypatch.setattr(P, "recent", lambda n: log)
    return Run(setup_s=1.0, window_s=1.0, latencies_s=[1e-3],
               answered_queries=counts.get("queries", 0), live_rows=1,
               mem_peak_bytes=None)


@pytest.mark.parametrize("name,field", [("lock_wait_ms", "lock_wait_ns"),
                                        ("lock_waiters", "lock_waiters"),
                                        ("lane_fill_pct", "scan_lanes"),
                                        ("block_requests", "block_requests")])
def test_readers_read_the_record_and_give_none_without_it(monkeypatch, name,
                                                          field):
    reader = spec.load_file(spec.metric_path(name), "t_" + name)
    r = one_record(monkeypatch, queries=1, lock_wait_ns=2_500_000,
                   lock_waiters=31, scan_lanes=128, block_requests=16)
    assert reader.read(r) == pytest.approx(
        {"lock_wait_ms": 2.5, "lock_waiters": 31.0,
         "lane_fill_pct": 100 / 128, "block_requests": 16.0}[name])
    r = one_record(monkeypatch, drop=field, queries=1, lock_waiters=31,
                   scan_lanes=128, block_requests=16)
    assert reader.read(r) is None


def test_a_window_above_65536_requests_reads():
    """A 40 s window of ~2,000 single-query requests a second (more than
    the 65,536 records the ring held before the combining front) fits in
    the ring: the window reads, and so do its readers. One more request
    than the ring holds, and it reads None."""
    n = 80_000
    assert P.RING_ROWS >= n
    for i in range(n):
        with P.request():
            P.count("queries", 1 if i % 4 == 0 else 0)
            P.count("block_requests", 4)
            P.count("lock_waiters", 30)
    r = Run(setup_s=1.0, window_s=40.0, latencies_s=[1e-3] * n,
            answered_queries=n // 4, live_rows=1, mem_peak_bytes=None)
    log = request_log.window(r)
    assert log is not None and len(log["queries"]) == n
    for name, want in (("block_requests", 4.0), ("lock_waiters", 30.0)):
        reader = spec.load_file(spec.metric_path(name), "t_w_" + name)
        assert reader.read(r) == want
    r.latencies_s = [1e-3] * (P.RING_ROWS + 1)
    assert request_log.window(r) is None


# -- the cell and its loop ------------------------------------------------------

def test_the_cell_loads():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic["loop"] == "clients"
    assert cell.traffic["clients"] == 32
    assert cell.traffic["request_queries"] == 1
    assert cell.config["dim"] == 960 and cell.config["rows"] == 10**6
    gist = spec.load_json(os.path.join(spec.HERE, "configs",
                                       "gist960-flat-1m.json"))
    for key in ("rows", "dim", "metric", "dtype", "generator", "limits"):
        assert cell.config[key] == gist[key]
    assert {m["name"] for m in cell.per_layer} >= set(READERS)


@pytest.mark.parametrize("loop,mix,said", [
    (loop_clients, {"clients": 1, "request_queries": 1}, "two clients"),
    (loop_clients, {"clients": 32, "request_queries": 5}, "one query"),
    (loop_clients, {"clients": 32, "request_queries": 1}, None),
    (loop_closed, {"clients": 32, "request_queries": 1}, "one client"),
])
def test_loops_refuse_what_they_do_not_drive(loop, mix, said):
    why = loop.refusal(mix)
    assert (why is None) if said is None else (said in why)


@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_tiny_run_of_the_cell(trace):
    """The cell end to end on the CPU, six clients: correct, every request
    checked, the lock queue in the record; no card, so no lanes."""
    result, lines = run.run_cell(tiny(), seed=2**31 + 9, seconds=1.0,
                                 trace=trace, device="cpu")
    assert result["correct"] is True, lines
    assert result["attempted"] > 6 and result["failed"] == 0
    window = next(x for x in lines if x.startswith("window: "))
    assert f"{result['attempted']} answers" in window
    m = result["metrics"]
    if trace:
        assert 0 <= m["lock_waiters"]["value"] <= 5
        assert m["lock_wait_ms"]["value"] >= 0
        assert "lane_fill_pct" not in m
        assert "scan_topk_roofline" not in m
    else:
        assert m["qps"]["value"] > 0 and "setup_s" in m


def test_a_crossed_reply_is_not_correct(monkeypatch):
    """A program that hands a client the reply to another client's query
    fails the check."""
    plain = T.HNSW.search_batch
    last = []
    swap = threading.Lock()

    def crossed(self, index, queries, *a, **kw):
        with swap:
            last.append(np.array(queries))
            q = last[-2] if len(last) > 1 else last[-1]
        return plain(self, index, q, *a, **kw)

    monkeypatch.setattr(T.HNSW, "search_batch", crossed)
    result, lines = run.run_cell(tiny(warmup_requests=0), seed=2**31 + 10,
                                 seconds=0.5, trace=False, device="cpu")
    assert result["correct"] is False, lines
    assert result["checks"]["rank_gap"]["value"] > 2e-05
