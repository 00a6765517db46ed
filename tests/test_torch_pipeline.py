"""The port's pipelined serving loop (ops/scan.py ``drain_pipelined``,
``FetchGroup``, ``fetch_handle``, the dispatch / finish halves) against
the JAX package's, on the CPU.

The JAX package's own tests (tests/test_scan.py, the pipelined-drain
and fetch-window tests) hold its loop to its serial form; these hold the
port's loop the same way, on every route that drains: the HNSW scan
(f32 exact, certified forced, hamming, bf16, int8), the graph engine,
ids-only replies, every flat tier with an odd tail and the sharded
index. Replies must be byte-identical at every depth and window, with
CERT_STATS alike, and on integer-lattice rows (every f32 score exact)
equal to the JAX package's replies under its own loop. The environment
grammar, the call order and the FetchGroup round trip are compared with
the JAX package's directly.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu.ops.scan as JS
import redis_hnsw_tpu.ops.search as JSE
import redis_hnsw_tpu_torch as T
import redis_hnsw_tpu_torch.ops.scan as TS
import redis_hnsw_tpu_torch.ops.search as TSE
from redis_hnsw_tpu_torch.parallel import ShardedHNSW as TShard
from redis_hnsw_tpu_torch.parallel import make_mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a chunk: one intra-op thread keeps them cheap under
    a parallel test run (the previous count is restored)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DEPTHS = (0, 1, 2, 4)
WINDOWS = (1, 3, 8)
N_Q = 150  # five 32-lane chunks, the last one 22 rows


def same_bits(a, b, label=""):
    assert np.array_equal(a[0], b[0]), label
    assert a[1].shape == b[1].shape, label
    assert np.array_equal(np.asarray(a[1], np.float32).view(np.int32),
                          np.asarray(b[1], np.float32).view(np.int32)), label


def objects(res):
    return [[(r.sim, r.name) for r in row] for row in res]


def every_setting(monkeypatch, search):
    """``search()`` at every depth x window, each against the serial
    loop (depth 0, window 1)."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    want = search()
    for depth in DEPTHS:
        for window in WINDOWS:
            monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", str(depth))
            monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", str(window))
            same_bits(search(), want, f"depth {depth} window {window}")
    return want


def gauss(rng, n, dim):
    return rng.standard_normal((n, dim)).astype(np.float32)


def hnsw_index(rng, metric="euclidean", n=400):
    """A port HNSW index of ``n`` rows (24-d floats, or 256-bit words)
    with every 7th row deleted, and its queries."""
    if metric == "hamming":
        data = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        qs = rng.integers(0, 2**32, (N_Q, 8), dtype=np.uint32)
        dim = 256
    else:
        data, qs, dim = gauss(rng, n, 24), gauss(rng, N_Q, 24), 24
    idx = T.HNSWIndex("p", T.IndexConfig(dim=dim, m=8, ef_construction=48,
                                         seed=5, metric=metric),
                      device="cpu")
    names = [f"n{i}" for i in range(n)]
    idx.add_batch(names, data, batch_size=128)
    idx.delete_batch(names[::7])
    return idx, qs


# -- the environment grammar and the machinery --------------------------------


@pytest.mark.parametrize("value", [None, "", "0", "-3", "1", "7"])
def test_pipeline_depth_env_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("REDIS_HNSW_TPU_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", value)
    assert TS.pipeline_depth() == JS.pipeline_depth()
    assert TS.pipeline_depth() == {None: 2, "": 2, "-3": 0}.get(
        value, int(value or 0))


def test_pipeline_depth_junk_raises_as_in_jax(monkeypatch):
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "deep")
    for pkg in (TS, JS):
        with pytest.raises(ValueError):
            pkg.pipeline_depth()


@pytest.mark.parametrize("value", [None, "", "0", "-2", "1", "3", "junk"])
def test_fetch_window_env_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("REDIS_HNSW_TPU_FETCH_WINDOW", raising=False)
    else:
        monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", value)
    for default in (1, 4, TS.FETCH_WINDOW_FAST, 0):
        assert TS.fetch_window(default) == JS.fetch_window(default)
    assert TS.fetch_window() == JS.fetch_window()
    assert TS.FETCH_WINDOW_FAST == JS.FETCH_WINDOW_FAST == 8


def test_fetch_group_round_trip():
    """Mixed dtypes and shapes come back from the one copy byte-identical
    and WRITABLE; bool and bfloat16 are refused; a launched group takes
    no more tensors; a one-tensor group still copies."""
    g = TS.FetchGroup()
    a = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    b = torch.linspace(-3.0, 9.0, 10).reshape(5, 2)
    c = torch.tensor([[1, -2], [3, 4]], dtype=torch.int8)
    d = torch.arange(6, dtype=torch.int64)[::2]  # not contiguous
    e = torch.tensor([7, 0, 255], dtype=torch.uint8)
    gets = [g.add(t) for t in (a, b, c, d, e)]
    with pytest.raises(TypeError, match="bool"):
        g.add(torch.ones(3, dtype=torch.bool))
    with pytest.raises(TypeError):
        g.add(torch.ones(3, dtype=torch.bfloat16))
    host = [get() for get in gets]
    for t, h in zip((a, b, c, d, e), host):
        assert h.dtype == t.numpy().dtype and h.shape == tuple(t.shape)
        assert np.array_equal(h, t.numpy())
        h.flat[0] = 1  # writable
    assert a[0, 0] == 0  # a copy, not a view of the source
    with pytest.raises(RuntimeError, match="launched"):
        g.add(a)
    g1 = TS.FetchGroup()
    get = g1.add(b)
    g1.launch()
    with pytest.raises(RuntimeError):
        g1.add(a)  # the copy is queued: the window is closed
    h = get()
    h[0, 0] = 2.5
    assert np.array_equal(get(), h)  # one host copy a tensor


def test_fetch_group_matches_jax_bytes():
    """The same arrays through the port's group and the JAX package's:
    the same host arrays."""
    rng = np.random.default_rng(3)
    arrays = [rng.integers(-9, 9, (5, 3)).astype(np.int32),
              rng.standard_normal((2, 7)).astype(np.float32),
              rng.integers(-100, 100, (4,)).astype(np.int8)]
    tg, jg = TS.FetchGroup(), JS.FetchGroup()
    tgets = [tg.add(torch.from_numpy(a)) for a in arrays]
    jgets = [jg.add(jnp.asarray(a)) for a in arrays]
    for tget, jget in zip(tgets, jgets):
        t, j = tget(), jget()
        assert t.dtype == j.dtype and np.array_equal(t, j)


def test_fetch_handle_outside_a_drain():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    get = TS.fetch_handle(t)
    h = get()
    assert np.array_equal(h, t.numpy()) and h.flags.writeable
    assert TS._ACTIVE_GROUPS.stack == []


def call_order(pkg, tensor, depth, window, n=7):
    """The dispatch (d) and finish (f) calls of ``pkg``'s drain over
    ``n`` parts, and the sink's flush (s)."""
    log = []

    def dispatch(i):
        log.append(f"d{i}")
        get = pkg.fetch_handle(tensor(i))

        def finish():
            log.append(f"f{i}")
            return get(), None

        return finish

    class Sink:
        def flush(self):
            log.append("s")

    ids, _ = pkg.drain_pipelined(((i,) for i in range(n)), dispatch,
                                 sink=Sink(), default_window=window)
    assert [int(np.asarray(p)[0]) for p in ids] == list(range(n))
    return log


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("window", [1, 2, 3])
def test_call_order_matches_jax(monkeypatch, depth, window):
    """Depth 2, window 1 gives d0 d1 d2 f0 d3 f1 ...: the port's drain
    calls the halves in the JAX package's order at every setting, and
    flushes the sink last."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", str(depth))
    monkeypatch.delenv("REDIS_HNSW_TPU_FETCH_WINDOW", raising=False)
    got = call_order(TS, lambda i: torch.full((2,), i, dtype=torch.int32),
                     depth, window)
    want = call_order(JS, lambda i: jnp.full((2,), i, jnp.int32), depth,
                      window)
    assert got == want
    assert got[-1] == "s"
    if depth == 2 and window == 1:
        assert got[:8] == ["d0", "d1", "d2", "f0", "d3", "f1", "d4", "f2"]


# -- pipelined == serial, route by route --------------------------------------


@pytest.mark.parametrize("tier", ["f32", "certified", "hamming", "bf16",
                                  "int8", "approx"])
def test_hnsw_scan_pipelined_equals_serial(rng, monkeypatch, tier):
    idx, qs = hnsw_index(rng, "hamming" if tier == "hamming" else
                         "euclidean")
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    if tier == "certified":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    if tier in ("bf16", "int8"):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", tier)
    engine = "scan-approx" if tier == "approx" else "scan"
    before = dict(TS.CERT_STATS)
    want = every_setting(monkeypatch, lambda: idx.search_batch(
        qs, 10, engine=engine, reply="columnar"))
    batches = TS.CERT_STATS["batches"] - before["batches"]
    assert batches == (13 * 5 if tier == "certified" else 0)
    monkeypatch.setattr(TSE, "MAX_LANES", 2048)  # one chunk
    same_bits(idx.search_batch(qs, 10, engine=engine, reply="columnar"),
              want, "one chunk")


@pytest.mark.parametrize("engine", ["scan", "graph"])
def test_ids_only_pipelined_equals_serial(rng, monkeypatch, engine):
    idx, qs = hnsw_index(rng)
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    full = idx.search_batch(qs, 10, engine=engine, reply="columnar",
                            ef_search=40)
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
    got = every_setting(monkeypatch, lambda: idx.search_batch(
        qs, 10, engine=engine, reply="columnar", ef_search=40))
    assert np.array_equal(got[0], full[0])


@pytest.mark.parametrize("seeds", [0, 4])
def test_graph_pipelined_equals_serial(rng, monkeypatch, seeds):
    idx, qs = hnsw_index(rng)
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    every_setting(monkeypatch, lambda: idx.search_batch(
        qs, 10, engine="graph", reply="columnar", ef_search=32,
        seeds=seeds))


@pytest.mark.parametrize("tier", ["f32", "certified", "bf16", "int8",
                                  "int8x1", "hamming", "approx"])
def test_flat_pipelined_equals_serial(rng, monkeypatch, tier):
    """Every flat tier with an odd tail, and the int8-resident tier's host
    rescore inside the finish half."""
    if tier == "hamming":
        data = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
        qs = rng.integers(0, 2**32, (N_Q, 8), dtype=np.uint32)
        cfg = T.IndexConfig(dim=256, metric="hamming")
    else:
        data, qs, cfg = gauss(rng, 500, 24), gauss(rng, N_Q, 24), \
            T.IndexConfig(dim=24)
    idx = T.FlatIndex("fp", cfg, device="cpu")
    idx.add_batch([f"n{i}" for i in range(len(data))], data)
    if tier == "certified":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    if tier.startswith("int8") or tier == "bf16":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", tier[:4])
    if tier == "int8x1":
        monkeypatch.setenv("REDIS_HNSW_TPU_INT8_RESCORE", "1")
    approx = tier == "approx"
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    want = every_setting(monkeypatch, lambda: idx.search_batch(
        qs, 7, approx=approx, reply="columnar"))
    monkeypatch.setattr(TSE, "MAX_LANES", 2048)
    same_bits(idx.search_batch(qs, 7, approx=approx, reply="columnar"),
              want, "one chunk")


@pytest.mark.parametrize("engine", ["scan", "certified", "graph", "int8"])
def test_sharded_pipelined_equals_serial(rng, monkeypatch, engine):
    data, qs = gauss(rng, 600, 16), gauss(rng, N_Q, 16)
    idx = TShard("sh", T.IndexConfig(dim=16, m=8, ef_construction=40,
                                     seed=3),
                 mesh=make_mesh(3, device="cpu"))
    idx.add_batch([f"n{i}" for i in range(600)], data, batch_size=128)
    if engine == "certified":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    if engine == "int8":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "int8")
    route = "graph" if engine == "graph" else "scan"
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    before = dict(TS.CERT_STATS)
    want = every_setting(monkeypatch, lambda: idx.search_batch(
        qs, 10, engine=route, reply="columnar", ef_search=32))
    batches = TS.CERT_STATS["batches"] - before["batches"]
    assert batches == (13 * 5 if engine == "certified" else 0)
    monkeypatch.setattr(TSE, "MAX_LANES", 2048)
    same_bits(idx.search_batch(qs, 10, engine=route, reply="columnar",
                               ef_search=32), want, "one chunk")


# -- the certified tier's fallbacks -------------------------------------------


def tie_heavy(rng):
    """Every row 8 times over, queries on the rows: a k = 12 cut splits a
    tie class on every query, so no query certifies."""
    base = gauss(rng, 40, 24)
    data = np.repeat(base, 8, axis=0)
    qs = np.repeat(base[:10], 13, axis=0)  # 130 queries
    return data, qs


@pytest.mark.parametrize("depth,window", [(0, 1), (2, 1), (2, 3), (4, 8)])
def test_certified_tie_fallbacks_counted(rng, monkeypatch, depth, window):
    """Tie classes force whole-chunk fallbacks inside the finish halves
    while later chunks are queued: replies byte-identical to the exact
    tier, and CERT_STATS count every chunk and every query. The JAX
    package certifies all 5 chunks; the port certifies those dispatched
    before the first whole-chunk fallback finishes, (depth + 1) x window,
    and counts the later ones as skipped (ops/scan.py CertHistory)."""
    data, qs = tie_heavy(rng)
    idx = T.HNSWIndex("p", T.IndexConfig(dim=24, m=8, ef_construction=48,
                                         seed=5), device="cpu")
    idx.add_batch([f"n{i}" for i in range(len(data))], data, batch_size=256)
    want = idx.search_batch(qs, 12, engine="scan", reply="columnar")
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", str(depth))
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", str(window))
    # an audited batch is no failure: no audit may land on the first one
    monkeypatch.setattr(TS, "CERT_AUDIT_EVERY", 0)
    before = dict(TS.CERT_STATS)
    got = idx.search_batch(qs, 12, engine="scan", reply="columnar")
    n_cert = min(5, (depth + 1) * window)
    q_cert = min(130, 32 * n_cert)
    assert TS.CERT_STATS["batches"] == before["batches"] + n_cert
    assert TS.CERT_STATS["queries"] == before["queries"] + q_cert
    assert TS.CERT_STATS["skipped_queries"] == (
        before["skipped_queries"] + 130 - q_cert)
    assert TS.CERT_STATS["fallback_queries"] == (
        before["fallback_queries"] + q_cert)
    same_bits(got, want)


@pytest.mark.parametrize("depth,window", [(0, 1), (2, 1), (2, 3)])
def test_certified_reruns_coalesce(rng, monkeypatch, depth, window):
    """Spurious uncertified verdicts on a few rows of every chunk: the
    reruns coalesce into ONE exact batch per call (CertRerunSink, flushed
    before the drain returns) and the spliced replies equal the exact
    tier's."""
    idx, _ = hnsw_index(rng)
    qs = gauss(rng, 128, 24)
    want = idx.search_batch(qs, 5, engine="scan", reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", str(depth))
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", str(window))
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    monkeypatch.setattr(TS, "CERT_AUDIT_EVERY", 0)
    real_cert = TS.scan_certified_l2

    def spoiled(vecs, sqn, live, qd, *, k):
        ids, sims, ok = real_cert(vecs, sqn, live, qd, k=k)
        ok = ok.clone()
        ok[::17] = False  # two spurious rows a 32-row chunk
        return ids, sims, ok

    monkeypatch.setattr(TS, "scan_certified_l2", spoiled)
    reruns = []
    real_rows = TS._exact_rows

    def counting(exact, qd, rows, *, k):
        reruns.append(len(rows))
        return real_rows(exact, qd, rows, k=k)

    monkeypatch.setattr(TS, "_exact_rows", counting)
    before = dict(TS.CERT_STATS)
    got = idx.search_batch(qs, 5, engine="scan", reply="columnar")
    assert reruns == [8]  # ONE rerun: two rows of each of 4 chunks
    assert TS.CERT_STATS["fallback_queries"] == (
        before["fallback_queries"] + 8)
    same_bits(got, want)


# -- threads ------------------------------------------------------------------


def test_two_threads_on_two_indexes(monkeypatch):
    """api.py's per-index locks let search_batch run on two indexes at
    once: each thread's replies join only its own fetch windows (the
    active-group stack is thread-local), so both equal their serial
    replies."""
    rng = np.random.default_rng(21)
    monkeypatch.setattr(TSE, "MAX_LANES", 16)
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "3")
    client = T.HNSW(device="cpu")
    work = {}
    for name, dim in (("a", 12), ("b", 20)):
        client.create_index(name, dim=dim, kind="flat")
        data = gauss(rng, 300, dim)
        client.add_batch(name, [f"{name}{i}" for i in range(300)], data)
        qs = gauss(rng, 70, dim)
        monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
        work[name] = (qs, objects(client.search_batch(name, qs, k=5)))
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "2")
    errors, done = [], []

    def run(name):
        qs, want = work[name]
        try:
            for _ in range(15):
                got = objects(client.search_batch(name, qs, k=5))
                if got != want:
                    errors.append(name)
        except Exception as e:  # reported below
            errors.append(repr(e))
        done.append(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(n,)) for n in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == ["a", "b"] and errors == []


# -- the JAX package's replies on lattice rows --------------------------------


def lattice(rng, n, dim, n_q):
    data = rng.integers(-3, 4, (n, dim)).astype(np.float32)
    data[200:260] = np.repeat(data[200:210], 6, axis=0)  # tie classes
    return data, rng.integers(-3, 4, (n_q, dim)).astype(np.float32)


@pytest.mark.parametrize("tier", ["f32", "certified"])
def test_flat_pipelined_matches_jax_on_lattice(rng, monkeypatch, tier):
    data, qs = lattice(rng, 500, 16, 130)
    names = [f"n{i}" for i in range(500)]
    a = J.FlatIndex("f", J.IndexConfig(dim=16))
    b = T.FlatIndex("f", T.IndexConfig(dim=16), device="cpu")
    for idx in (a, b):
        idx.add_batch(names, data)
        idx.delete_batch(names[::11])
    monkeypatch.setattr(JSE, "MAX_LANES", 32)
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "2")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "3")
    if tier == "certified":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    same_bits(b.search_batch(qs, 10, reply="columnar"),
              a.search_batch(qs, 10, reply="columnar"))


@pytest.mark.parametrize("tier", ["f32", "certified", "one-chunk"])
def test_hnsw_scan_pipelined_matches_jax_on_lattice(rng, monkeypatch, tier):
    """The scan route in 32-lane chunks, on the exact and the certified
    tier, against the JAX package's; and ("one-chunk") the 130 queries as
    one certified chunk, which the route also serves through the drain,
    against the JAX package's one-call ``scan_batch``."""
    data, qs = lattice(rng, 400, 16, 130)
    names = [f"n{i}" for i in range(400)]
    a = J.HNSWIndex("h", J.IndexConfig(dim=16, m=6, ef_construction=24,
                                       seed=2))
    b = T.HNSWIndex("h", T.IndexConfig(dim=16, m=6, ef_construction=24,
                                       seed=2), device="cpu")
    for idx in (a, b):
        for name, row in zip(names, data):
            idx.add_node(name, row)
        idx.delete_batch(names[::9])
    if tier != "one-chunk":
        monkeypatch.setattr(JSE, "MAX_LANES", 32)
        monkeypatch.setattr(TSE, "MAX_LANES", 32)
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "2")
    if tier != "f32":
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    got = b.search_batch(qs, 10, engine="scan", reply="columnar")
    same_bits(got, a.search_batch(qs, 10, engine="scan", reply="columnar"))
    if tier == "one-chunk":
        ids, sims = JS.scan_batch(a, qs, 10)
        same_bits(got, (np.asarray(names, object)[ids], sims))
    # the one-call form, on row ids
    same_bits(TS.scan_batch(b, qs[:20], 10), JS.scan_batch(a, qs[:20], 10))
