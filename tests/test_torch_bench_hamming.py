"""The sift-256-hamming deployment on the CPU at small sizes: the port's
flat hamming path against the benchmark's plain Hamming reference
(``bench_gpu/reference/hamming.py``, the one copy the benchmark's
``correct`` also uses), the bit-code generator, the comparison and its
control on Hamming answers, a whole tiny run of the cell, and the
request record's ``exact_queries`` counter and ring size that its
metrics read.

Hamming distances are integers and the reply's sims are exactly
``-distance``, so every comparison here is exact; where several rows
tie at the k-th distance either may be named, so answers compare as
distance lists and tie-aware sets.
"""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T
from bench_gpu import control, request_log, run, spec
from bench_gpu.gen import clustered_bits as GB
from bench_gpu.record import Run, TraceData
from bench_gpu.reference import compare
from bench_gpu.reference import hamming as ref
from redis_hnsw_tpu_torch.utils import profiling as P

CELL = "sift256-hamming.batch"


def words(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def popcount_dist(a, b):
    """Hamming distance of two uint32 word rows, one Python int a word."""
    return sum(bin(int(x) ^ int(y)).count("1") for x, y in zip(a, b))


def hamming_client(data, name="h"):
    client = T.HNSW(device="cpu")
    index = client.create_index(name, dim=32 * data.shape[1],
                                metric="hamming", capacity=len(data),
                                kind="flat")
    client.add_batch(name, [str(i) for i in range(len(data))], data)
    return client, index


def tiny(rows=4000, **mix):
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, rows=rows,
                       generator=dict(cell.config["generator"], centres=32))
    cell.traffic = dict(cell.traffic, request_queries=200,
                        pool_rate_per_s=40, **mix)
    return cell


# -- the reference ------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 3, 8])
def test_reference_matches_a_popcount_loop(rng, w):
    x = words(rng, 90, w)
    q = words(rng, 7, w)
    x[11] = q[3]  # distance 0
    want = np.array([[popcount_dist(a, b) for b in x] for a in q])
    idx, dist = ref.knn(torch.from_numpy(x), torch.from_numpy(q), 12)
    assert dist.dtype == torch.float64
    assert np.array_equal(dist.numpy(), np.sort(want, axis=1)[:, :12])
    assert np.array_equal(
        np.take_along_axis(want, idx.numpy(), 1), dist.numpy())
    got = ref.pair_dist(torch.from_numpy(x), torch.from_numpy(q), idx)
    assert np.array_equal(got.numpy(), dist.numpy())
    # int32 words (the port's device form) are the same bits
    i32 = ref.knn(torch.from_numpy(x.view(np.int32)),
                  torch.from_numpy(q.view(np.int32)), 12)[1]
    assert np.array_equal(i32.numpy(), dist.numpy())
    assert np.array_equal(ref.similarity(dist.numpy()), -dist.numpy())


def test_reference_control_scores_one_word_short(rng):
    x, q = words(rng, 60, 4), words(rng, 5, 4)
    want = np.array([[popcount_dist(a[:3], b[:3]) for b in x] for a in q])
    _, dist = ref.knn(torch.from_numpy(x), torch.from_numpy(q), 6, "tf32")
    assert np.array_equal(dist.numpy(), np.sort(want, axis=1)[:, :6])
    with pytest.raises(ValueError):
        ref.knn(torch.from_numpy(x), torch.from_numpy(q), 6, "bf16")
    with pytest.raises(TypeError):
        ref.unpack(torch.zeros((2, 2), dtype=torch.int64))


# -- the port's flat hamming path against it ----------------------------------

def reply_rows(reply, k):
    """Object reply -> ([Q, k] row ids, [Q, k] sims)."""
    ids = np.array([[int(r.name) for r in res] for res in reply])
    sims = np.array([[r.sim for r in res] for res in reply], np.float64)
    assert ids.shape[1] == k
    return ids, sims


def check_exact(x, q, ids, sims, k, live):
    """Each answer: k distinct live rows, sims exactly -distance, nearest
    first, and the reference's distance list over the live rows (ties
    either way)."""
    qt = torch.from_numpy(q)
    _, want = ref.knn(torch.from_numpy(x[live]), qt, k)
    d = ref.pair_dist(torch.from_numpy(x), qt, torch.from_numpy(ids))
    assert live[ids].all()
    assert all(len(set(r)) == k for r in ids.tolist())
    assert np.array_equal(sims, -d.numpy())
    assert (np.diff(sims, axis=1) <= 0).all()
    assert np.array_equal(d.numpy(), want.numpy())


@pytest.mark.parametrize("n,w,k", [(300, 1, 1), (1000, 8, 10), (2500, 4, 7),
                                   (700, 16, 25)])
def test_flat_hamming_path_matches_the_reference(rng, n, w, k):
    x = words(rng, n, w)
    x[n // 2 : n // 2 + 6] = x[5]           # planted ties: six copies of a row
    q = words(rng, 40, w)
    q[0] = x[5]                              # distance 0, tied six ways
    q[1] = x[17]                             # distance 0, a row to delete
    q[2] = x[5] ^ np.uint32(1)               # distance 1 to the tied rows
    client, index = hamming_client(x)
    dead = [17, 40, n - 1]
    client.delete_batch("h", [str(i) for i in dead])
    live = np.ones(n, bool)
    live[dead] = False
    ids, sims = reply_rows(client.search_batch("h", q, k=k, engine="auto"), k)
    check_exact(x, q, ids, sims, k, live)
    assert np.signbit(sims[0, 0]) and sims[0, 0] == 0.0   # -0.0
    # the columnar reply is the same answer
    names, csims = index.search_batch(q, k, reply="columnar")
    assert np.array_equal(names.astype(np.int64), ids)
    assert np.array_equal(csims.astype(np.float64), sims)
    assert np.signbit(csims[0, 0])


# -- the generator ------------------------------------------------------------

def test_bit_packing_round_trips(rng):
    x = torch.randn(300, 96, generator=torch.Generator().manual_seed(3))
    w = GB.pack_bits(x)
    assert w.dtype == torch.int32 and w.shape == (300, 3)
    u = w.numpy().view(np.uint32)
    assert np.array_equal(GB.unpack_bits(u), (x > 0).numpy())
    back = GB.pack_bits(torch.from_numpy(GB.unpack_bits(u)).float() * 2 - 1)
    assert np.array_equal(back.numpy().view(np.uint32), u)
    # bit j of word w is dimension 32 w + j, as the reference unpacks it
    assert np.array_equal(ref.unpack(torch.from_numpy(u)).numpy(),
                          GB.unpack_bits(u).astype(np.float32))
    with pytest.raises(ValueError):
        GB.pack_bits(torch.randn(4, 40))


def test_generator_is_deterministic_in_the_seed():
    cell = tiny(rows=3000)
    a = GB.make_inputs(cell.config, cell.traffic, 2**31 + 17, "cpu", 5)
    b = GB.make_inputs(cell.config, cell.traffic, 2**31 + 17, "cpu", 5)
    c = GB.make_inputs(cell.config, cell.traffic, 2**31 + 18, "cpu", 5)
    for name in ("rows", "warm", "pool", "samples"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.rows, c.rows)
    assert not np.array_equal(a.pool, c.pool)
    assert a.rows.shape == (3000, 8) and a.rows.dtype == np.uint32
    assert a.warm.shape == (2 * 200, 8) and a.pool.shape == (5 * 200, 8)
    assert a.samples.shape == (5, 16)
    # codes of a clustered mixture: a query's nearest codes are far nearer
    # than the half-way 128 bits of unrelated codes
    _, d = ref.knn(torch.from_numpy(a.rows), torch.from_numpy(a.pool[:50]),
                   10)
    assert d.max() < 110 and d[:, 0].min() > 0
    other = dict(cell.config, generator=dict(cell.config["generator"],
                                             kind="clustered"))
    with pytest.raises(ValueError):
        GB.make_inputs(other, cell.traffic, 1, "cpu", 1)
    with pytest.raises(ValueError):
        GB.make_inputs(cell.config, dict(cell.traffic, load_order="cluster"),
                       1, "cpu", 1)


# -- the comparison and its control ------------------------------------------

def hamming_inputs(rng, n=1500, b=20, n_pool=4, m=6):
    rows = words(rng, n, 8)
    pool = words(rng, n_pool * b, 8)
    pool[3] = rows[9]
    samples = np.stack([np.sort(rng.choice(b, m, replace=False))
                        for _ in range(n_pool)])
    return GB.Inputs(rows=rows, warm=pool[:0], pool=pool, samples=samples)


def exact_taken(inputs, k, b):
    """The reference's own answers in the run's (pool request, ids, sims,
    bad) form."""
    out = []
    for pr in range(len(inputs.samples)):
        qs = inputs.pool[pr * b + inputs.samples[pr]]
        idx, dist = ref.knn(torch.from_numpy(inputs.rows),
                            torch.from_numpy(qs), k)
        out.append((pr, idx.numpy(), ref.similarity(dist.numpy()),
                    np.zeros(len(qs), bool)))
    return out


def test_readings_of_hamming_answers(rng):
    k, b = 10, 20
    inputs = hamming_inputs(rng, b=b)
    limits = {"bad_answers": 0, "sim_err": 0, "rank_gap": 0}
    taken = exact_taken(inputs, k, b)
    values = run.check_answers(inputs, taken, "hamming", len(inputs.rows),
                               k, b, "cpu")
    assert values == {"bad_answers": 0, "sim_err": 0.0, "rank_gap": 0.0}
    assert compare.judge(values, limits)[0]
    # one named row swapped for a farther one: rank_gap
    pr, ids, sims, bad = taken[0]
    qs = inputs.pool[pr * b + inputs.samples[pr]]
    d_all = ref.pair_dist(torch.from_numpy(inputs.rows), torch.from_numpy(
        qs[:1]), torch.arange(len(inputs.rows))[None]).numpy()[0]
    far = int(np.argmax(d_all))
    ids2, sims2 = ids.copy(), sims.copy()
    ids2[0, -1], sims2[0, -1] = far, -d_all[far]
    values = run.check_answers(inputs, [(pr, ids2, sims2, bad)] + taken[1:],
                               "hamming", len(inputs.rows), k, b, "cpu")
    assert values["rank_gap"] > 0 and values["sim_err"] == 0
    assert not compare.judge(values, limits)[0]
    # one sim off by 1: sim_err
    sims3 = sims.copy()
    sims3[1, -1] -= 1
    values = run.check_answers(inputs, [(pr, ids, sims3, bad)] + taken[1:],
                               "hamming", len(inputs.rows), k, b, "cpu")
    assert values["sim_err"] > 0 and not compare.judge(values, limits)[0]


def test_the_control_fails_and_the_program_passes():
    """The control (codes scored one word short) comes out not correct on
    every seed; a whole tiny run of the cell, the port in the timed path,
    comes out correct with every query on the exact tier."""
    cell = tiny(rows=4000)
    for seed in (11, 12, 13):
        out = control.run_control(cell, seed, 8, "cpu")
        assert out["correct"] is False, out
        assert out["checks"]["sim_err"]["value"] > 0
    result, lines = run.run_cell(cell, seed=2**31 + 5, seconds=1.0,
                                 trace=True, device="cpu")
    assert result["correct"] is True, lines
    assert result["checks"]["rank_gap"]["value"] == 0
    assert result["checks"]["sim_err"]["value"] == 0
    assert result["metrics"]["exact_tier_pct"]["value"] == 100.0
    # no card: no device metric
    assert "scan_topk_hamming_roofline" not in result["metrics"]


# -- the record: exact_queries and the ring -----------------------------------

def flat_l2(rng, n=600, dim=16):
    client = T.HNSW(device="cpu")
    client.create_index("e", dim=dim, kind="flat")
    client.add_batch("e", [f"e{i}" for i in range(n)],
                     rng.standard_normal((n, dim)).astype(np.float32))
    return client


@pytest.mark.parametrize("case", ["hamming", "hamming-cert", "euclidean",
                                  "euclidean-cert", "approx", "bf16",
                                  "use_pallas"])
def test_exact_queries_counts_the_exact_tier(rng, monkeypatch, case):
    n_q = 37
    if case.startswith("hamming"):
        if case == "hamming-cert":
            monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        client, _ = hamming_client(words(rng, 800, 8))
        client.search_batch("h", words(rng, n_q, 8), k=5)
    elif case == "use_pallas":
        client = flat_l2(rng)
        with P.request():
            client.index("e").search_batch(
                rng.standard_normal((n_q, 16)).astype(np.float32), 5,
                use_pallas=True)
    else:
        if case == "euclidean-cert":
            monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        if case == "bf16":
            monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "bf16")
        client = flat_l2(rng)
        client.search_batch(
            "e", rng.standard_normal((n_q, 16)).astype(np.float32), k=5,
            engine="scan-approx" if case == "approx" else "auto")
    log = P.recent(1)
    assert log["queries"].tolist() == [n_q]
    exact = 0 if case in ("hamming-cert", "euclidean-cert", "bf16") else n_q
    assert log["exact_queries"].tolist() == [exact]
    cert = n_q if case.endswith("-cert") else 0
    assert log["cert_queries"].tolist() == [cert]
    assert client.request_log(1)["exact_queries"].tolist() == [exact]


def test_the_ring_holds_a_window_of_the_hamming_cell():
    """A 40 s window at 1,000 requests a second fits in the ring, and the
    benchmark's reader returns the whole window from it."""
    assert P.RING_ROWS >= 40 * 1000
    n = P.RING_ROWS
    for i in range(n):
        with P.request():
            P.count("queries", 1000)
            P.count("exact_queries", 1000)
    r = Run(setup_s=1.0, window_s=40.0, latencies_s=[1e-3] * n,
            answered_queries=1000 * n, live_rows=1, mem_peak_bytes=None)
    log = request_log.window(r)
    assert log is not None and len(log["queries"]) == n
    reader = spec.load_file(spec.metric_path("exact_tier_pct"), "t_etp")
    assert reader.read(r) == 100.0
    r.latencies_s = [1e-3] * (n + 1)
    r.answered_queries += 1000
    assert request_log.window(r) is None


def test_new_readers_give_none_without_their_source(monkeypatch):
    """The parent program's record has no ``exact_queries``, and a run
    without a trace has no A′ time: each reader gives None."""
    etp = spec.load_file(spec.metric_path("exact_tier_pct"), "t_etp2")
    roof = spec.load_file(spec.metric_path("scan_topk_hamming_roofline"),
                          "t_sthr")
    with P.request():
        P.count("queries", 8)
    log = {f: c for f, c in P.recent(1).items() if f != "exact_queries"}
    monkeypatch.setattr(P, "recent", lambda n: log)
    r = Run(setup_s=1.0, window_s=1.0, latencies_s=[1e-3],
            answered_queries=8, live_rows=1, mem_peak_bytes=None)
    assert request_log.window(r) is not None
    assert etp.read(r) is None
    assert roof.read(r) is None
    r.trace = TraceData(window_s=1.0, busy_s=0.5, device_events=3,
                        port_kernel_s=0.4,
                        least_s={"scan_topk_hamming": 0.1},
                        kernel_s={"scan_topk_hamming": 0.4})
    assert roof.read(r) == pytest.approx(25.0)


@pytest.mark.parametrize("skipped", [0, 1250, None])
def test_cert_skip_pct_reads_the_record(monkeypatch, skipped):
    """cert_skip_pct: ``cert_skipped_queries`` over ``queries`` in the
    window's records, 0 where no chunk was skipped; None where the record
    has no such field, as the parent program's has not."""
    reader = spec.load_file(spec.metric_path("cert_skip_pct"), "t_csp")
    with P.request():
        P.count("queries", 5000)
        P.count("cert_skipped_queries", skipped or 0)
    log = P.recent(1)
    if skipped is None:
        log = {f: c for f, c in log.items() if f != "cert_skipped_queries"}
    monkeypatch.setattr(P, "recent", lambda n: log)
    r = Run(setup_s=1.0, window_s=1.0, latencies_s=[1e-3],
            answered_queries=5000, live_rows=1, mem_peak_bytes=None)
    assert request_log.window(r) is not None
    assert reader.read(r) == (None if skipped is None
                              else 100.0 * skipped / 5000)
