"""The certified hamming tier of the port against the JAX package's, on
the CPU, with REDIS_HNSW_TPU_SCAN_CERT=1.

Seeded random words (high bit included) and planted tie classes go
through both packages: the HNSW scan route, the flat index and the
sharded index (the JAX package on its 8-device virtual CPU mesh, the port
on the CPU repeated 8 times, and (2, 4) meshes of each). The JAX side
runs as its own tests run it: its select is exact on the CPU
(``approx_max_k`` there is ``top_k``), as kernel A′'s is everywhere, so
both packages certify the same queries. Replies are compared byte for
byte (ids, names, sims: both packages give a zero distance as -0.0 on
the single index; the JAX package's sharded reply gives +0.0, so there
sims compare by value, as tests/test_torch_sharded.py records), and the
CERT_STATS counts of a call -- batches, queries,
fallback queries -- must be equal. Kernel B′'s plain version is held
against the JAX package's XLA count at the same thresholds, t = -inf
included. Hamming scores are integers, so nothing has a tolerance.
"""

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
from redis_hnsw_tpu.models.flat import FlatIndex as JFlat
from redis_hnsw_tpu.parallel import ShardedHNSW as JShard
from redis_hnsw_tpu.parallel import make_mesh as jmesh
from redis_hnsw_tpu.parallel import make_mesh2d as jmesh2d
from redis_hnsw_tpu_torch.models.flat import FlatIndex as TFlat
from redis_hnsw_tpu_torch.ops import cuda_count_hamming, cuda_scan
from redis_hnsw_tpu_torch.parallel import ShardedHNSW as TShard
from redis_hnsw_tpu_torch.parallel import make_mesh, make_mesh2d

KEYS = ("batches", "queries", "fallback_queries")


@pytest.fixture(autouse=True)
def cert_on(monkeypatch):
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")


def words(rng, n, w=8):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def tw(a):
    """uint32 words as the port's int32 tensor (same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def stats():
    return dict(TS.CERT_STATS), dict(JS.CERT_STATS)


def deltas(before):
    """(port, JAX) CERT_STATS counts since ``before`` (:func:`stats`)."""
    tb, jb = before
    return ({k: TS.CERT_STATS[k] - tb[k] for k in KEYS},
            {k: JS.CERT_STATS[k] - jb[k] for k in KEYS})


def same_cols(ra, rb, by_value=False):
    """Columnar replies: names equal, sims byte for byte (or by value,
    where the JAX package gives a zero distance as +0.0)."""
    assert np.array_equal(ra[0], rb[0])
    assert ra[1].shape == rb[1].shape
    if by_value:
        assert np.array_equal(ra[1], rb[1])
    else:
        assert np.array_equal(ra[1].view(np.int32), rb[1].view(np.int32))


def hnsw_pair(data, batch=256):
    names = [f"n{i}" for i in range(len(data))]
    kw = dict(dim=32 * data.shape[1], m=8, ef_construction=48,
              metric="hamming", seed=5)
    a = J.HNSWIndex("h", J.IndexConfig(**kw))
    b = T.HNSWIndex("h", T.IndexConfig(**kw), device="cpu")
    a.add_batch(names, data, batch_size=batch)
    b.add_batch(names, data, batch_size=batch)
    return a, b


def flat_pair(data):
    names = [f"n{i}" for i in range(len(data))]
    kw = dict(dim=32 * data.shape[1], metric="hamming")
    a = JFlat("f", J.IndexConfig(**kw))
    b = TFlat("f", T.IndexConfig(**kw), device="cpu")
    a.add_batch(names, data)
    b.add_batch(names, data)
    return a, b


def served(pair, qs, k, **kw):
    """Both packages' columnar replies and CERT_STATS counts of one call
    each: (JAX reply, port reply, port counts, JAX counts)."""
    before = stats()
    want = pair[0].search_batch(qs, k, reply="columnar", **kw)
    got = pair[1].search_batch(qs, k, reply="columnar", **kw)
    return (want, got) + deltas(before)


def exact_reply(monkeypatch, idx, qs, k, **kw):
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "0")
    out = idx.search_batch(qs, k, reply="columnar", **kw)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    return out


# -- kernel B′'s plain version against the JAX package's count --------------------

@pytest.mark.parametrize("B,N,W", [(7, 300, 8), (16, 1000, 3), (5, 130, 1),
                                   (9, 257, 25)])
def test_plain_count_matches_jax(rng, B, N, W):
    """The same counts as ``_count_vs_threshold_hamming`` over the +-1
    table at the k-th selected score, at t = -inf (dead rows count as
    ==), above every score and below every score, and with a tie class
    at t."""
    q = words(rng, B, W)
    x = words(rng, N, W)
    x[N // 2 : N // 2 + 4] = x[N // 3]  # a tie class at every distance
    x[N // 4] = q[0]  # distance 0
    live = rng.random(N) > 0.2
    bias = cuda_scan.hamming_bias(torch.from_numpy(live))
    _, sims = cuda_scan.flat_topk_hamming(tw(q), tw(x), bias, k=10)
    t = sims[:, 9].clone()
    t[1] = float("-inf")
    t[2] = 0.5  # above every score
    t[3] = -32.0 * W - 1  # below every score
    if B > 4:
        t[4] = -2.5  # between integers: no row is ==
    got = cuda_count_hamming.count_hamming(tw(q), tw(x), bias, t)
    want = JS._count_vs_threshold_hamming(
        JS.pm1_table(jnp.asarray(x)), jnp.asarray(live),
        JS.pm1_table(jnp.asarray(q)), jnp.asarray(t.numpy()))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    n_live = int(live.sum())
    assert got[0][1] == n_live and got[1][1] == N - n_live
    assert got[0][2] == got[1][2] == 0
    assert got[0][3] == n_live and got[1][3] == 0


def test_plain_count_chunks(rng, monkeypatch):
    """The plain version's row chunks (a pair budget of 8 words: one row
    a chunk) give the one-chunk counts."""
    q, x = words(rng, 3, 2), words(rng, 50, 2)
    bias = cuda_scan.hamming_bias(torch.from_numpy(rng.random(50) > 0.3))
    t = torch.tensor([-20.0, float("-inf"), -31.0])
    want = cuda_count_hamming.count_hamming(tw(q), tw(x), bias, t)
    monkeypatch.setattr(cuda_count_hamming, "PLAIN_PAIR_WORDS", 8)
    got = cuda_count_hamming.count_hamming(tw(q), tw(x), bias, t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="float32"):
        cuda_count_hamming.count_hamming(tw(q), tw(x), bias, t.double())


# -- the single index: scan route and flat index -----------------------------------

def test_certified_hamming_matches_exact(rng, monkeypatch):
    """The scan route and the flat index: byte-equal to the exact tier
    and to the JAX package's certified tier, with its CERT_STATS counts;
    recall_target=1.0 rides the same tier."""
    data = words(rng, 600)
    qs = words(rng, 32)
    qs[0] = data[5]
    h, f = hnsw_pair(data), flat_pair(data)
    want = exact_reply(monkeypatch, h[1], qs, 10, engine="scan")
    for pair, kw in ((h, dict(engine="scan")), (f, {}),
                     (h, dict(recall_target=1.0))):
        jr, tr, td, jd = served(pair, qs, 10, **kw)
        same_cols(tr, want)
        same_cols(jr, tr)
        assert td == jd and td["batches"] == 1 and td["queries"] == 32
    assert np.signbit(want[1][0, 0]) and want[1][0, 0] == 0


def test_certified_hamming_straddling_ties_certify(rng, monkeypatch):
    """Every row 8 times, k = 10: the 10th distance's tie class straddles
    k but fits in the 40-deep selection, so every query certifies."""
    data = np.repeat(words(rng, 60), 8, axis=0)
    qs = words(rng, 16)
    h = hnsw_pair(data)
    want = exact_reply(monkeypatch, h[1], qs, 10, engine="scan")
    jr, tr, td, jd = served(h, qs, 10, engine="scan")
    same_cols(tr, want)
    same_cols(jr, tr)
    assert td == jd == {"batches": 1, "queries": 16, "fallback_queries": 0}


def test_certified_hamming_oversized_tie_falls_back(rng, monkeypatch):
    """A tie class of 48 copies at distance 0, deeper than the selection:
    every query falls back (the whole batch, more than a quarter) and
    gets the class's lowest ids."""
    base = words(rng, 12)
    h = hnsw_pair(np.repeat(base, 48, axis=0))
    qs = base[:8].copy()
    want = exact_reply(monkeypatch, h[1], qs, 10, engine="scan")
    jr, tr, td, jd = served(h, qs, 10, engine="scan")
    same_cols(tr, want)
    same_cols(jr, tr)
    assert td == jd and td["fallback_queries"] == 8
    assert tr[0][1].tolist() == [f"n{48 + i}" for i in range(10)]


def test_certified_hamming_short_selection_not_certified(rng, monkeypatch):
    """A selection truncated after 6 entries (as a lossy approximate
    select could return) must not certify through the t = -inf escape:
    c_gt == s_gt fails unless every live row was selected. Both
    packages' selections truncated alike fall back on every query."""
    data = words(rng, 300)
    qs = words(rng, 8)
    h = hnsw_pair(data)
    want = exact_reply(monkeypatch, h[1], qs, 10, engine="scan")
    real_t, real_j = TS.scan_topk, JS.scan_topk

    def truncating_t(*args, k, **kw):
        ids, sims = real_t(*args, k=k, **kw)
        if k > 10:  # the oversampled selection, not the exact fallback
            ids, sims = ids.clone(), sims.clone()
            ids[:, 6:] = -1
            sims[:, 6:] = float("-inf")
        return ids, sims

    def truncating_j(table, sqn, live, q, *, k, **kw):
        out = real_j(table, sqn, live, q, k=k, **kw)
        if not (kw.get("approx") and kw.get("full_sel")):
            return out
        ids, sims = out
        return ids.at[:, 6:].set(-1), sims.at[:, 6:].set(JS.NEG_INF)

    monkeypatch.setattr(TS, "scan_topk", truncating_t)
    monkeypatch.setattr(JS, "scan_topk", truncating_j)
    JS.scan_certified_hamming.clear_cache()
    try:
        jr, tr, td, jd = served(h, qs, 10, engine="scan")
    finally:
        JS.scan_certified_hamming.clear_cache()
    same_cols(tr, want)
    same_cols(jr, tr)
    assert td == jd and td["fallback_queries"] == 8


def test_certified_hamming_deletes_and_edges(rng, monkeypatch):
    """Deletes stay masked on both routes; k above the live rows
    certifies through c_gt (t = -inf, every live row selected)."""
    data = words(rng, 300)
    names = [f"n{i}" for i in range(300)]
    h, f = hnsw_pair(data), flat_pair(data)
    for pair in (h, f):
        for idx in pair:
            idx.delete_batch(names[::2])
    for pair, kw in ((h, dict(engine="scan")), (f, {})):
        jr, tr, td, jd = served(pair, data[:8], 5, **kw)
        same_cols(jr, tr)
        assert set(tr[0].ravel()) <= set(names[1::2])
        assert td == jd
    for pair, kw in ((hnsw_pair(data[:12], batch=4), dict(engine="scan")),
                     (flat_pair(data[:12]), {})):
        jr, tr, td, jd = served(pair, data[:2], 40, **kw)
        same_cols(jr, tr)
        assert (tr[0][:, :12] != None).all() and (tr[0][:, 12:] == None).all()  # noqa: E711
        assert td == jd and td["fallback_queries"] == 0


@pytest.mark.parametrize("window", ["3", None])
def test_fetch_window_certified_hamming_with_fallback(rng, monkeypatch,
                                                      window):
    """130 tie-heavy queries in 32-lane chunks under the pipelined drain,
    a fetch window of 3 and the default one (FETCH_WINDOW_FAST where the
    certified tier runs): fallbacks coalesce through the sink's hamming
    rerun; replies byte-equal to the exact tier and the JAX package's,
    CERT_STATS counts equal."""
    base = words(rng, 12)
    h = hnsw_pair(np.repeat(base, 48, axis=0))
    qs = np.repeat(base[:10], 13, axis=0)
    qs[::7] = words(rng, len(qs[::7]))
    want = exact_reply(monkeypatch, h[1], qs, 10, engine="scan")
    monkeypatch.setattr(JSE, "MAX_LANES", 32)
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    if window:
        monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", window)
    jr, tr, td, jd = served(h, qs, 10, engine="scan")
    same_cols(tr, want)
    same_cols(jr, tr)
    assert td == jd and td["batches"] == 5 and td["queries"] == 130
    assert td["fallback_queries"] > 0


# -- the gates: the word pack, the auto rule, the fetch window ---------------------

def test_hamming_cert_ready_word_pack_gate(monkeypatch):
    """Both gates of the JAX package: with the tier forced on, a table
    whose (dist << id_bits) | id word cannot fit 31 bits is not served;
    the count's dim gate still applies when it fits."""
    w = 8  # 256 bits: d_bits.bit_length() = 9, so id_bits <= 22
    for n in (2**22, 2**22 + 1, 2**23, 1000):
        assert TS.hamming_cert_ready(n, w) == JS.hamming_cert_ready(n, w)
    assert TS.hamming_cert_ready(2**22, w)
    assert not TS.hamming_cert_ready(2**23, w)
    assert TS.hamming_cert_enabled(2**23, w)  # the sharded gate: no pack
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "0")
    assert not TS.hamming_cert_ready(2**22, w)
    assert not JS.hamming_cert_ready(2**22, w)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "2")
    with pytest.raises(ValueError):
        TS.hamming_cert_ready(1000, w)


def test_auto_keeps_hamming_on_the_exact_tier(monkeypatch):
    """The H100's rule: under auto a hamming table never takes the
    certified tier, where the JAX package's gates would certify from
    2^19 rows (flat-hamming-sift256's 1,000,000 x 8 words among them);
    euclidean tables keep the JAX package's auto rule."""
    monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT")
    for n in (2**19, 1_000_064, 2**22):
        assert JS.hamming_cert_ready(n, 8)
        assert not TS.hamming_cert_ready(n, 8)
        assert not TS.hamming_cert_enabled(n, 8)
        assert TS.cert_enabled(n, 128) == JS.cert_enabled(n, 128)


@pytest.mark.parametrize("metric,cert,approx,dtype,window", [
    pytest.param("hamming", "1", False, "f32", 8, id="1-8"),
    pytest.param("hamming", "0", False, "f32", 1, id="0-1"),
    pytest.param("hamming", None, False, "f32", 1, id="None-1"),
    pytest.param("euclidean", "1", False, "f32", 8, id="euclidean-1-8"),
    pytest.param("euclidean", "0", False, "f32", 1, id="euclidean-0-1"),
    pytest.param("euclidean", None, False, "f32", 8, id="euclidean-None-8"),
    pytest.param("euclidean", "1", True, "f32", 8, id="euclidean-approx-8"),
    pytest.param("euclidean", "1", False, "bf16", 1, id="euclidean-bf16-1"),
])
def test_window_default_follows_the_tier(rng, monkeypatch, metric, cert,
                                         approx, dtype, window):
    """The drain's default fetch window is FETCH_WINDOW_FAST exactly where
    ``certified_serves`` says a certified tier serves or the approx tier
    does, and 1 where the exact tier does, on the scan route and the flat
    index; the tier that served (CERT_STATS queries, the record's
    ``exact_queries``) is the one ``certified_serves`` names. Hamming: the
    certified tier under SCAN_CERT=1 only (auto keeps the exact tier).
    Euclidean: under auto as well, with CERT_MIN_ROWS cut to these
    tables' size; the approx tier and a bf16 table never certify (a tier
    table's queries are not counted as the exact tier's)."""
    from redis_hnsw_tpu_torch.utils import profiling

    if cert is None:
        monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT")
    else:
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", cert)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
    monkeypatch.setattr(TS, "CERT_MIN_ROWS", 8)
    monkeypatch.setattr(TSE, "MAX_LANES", 8)
    seen = []
    real = TS.drain_pipelined

    def drain(parts, dispatch, *, sink=None, default_window=1):
        seen.append(default_window)
        return real(parts, dispatch, sink=sink, default_window=default_window)

    monkeypatch.setattr(TS, "drain_pipelined", drain)
    names = [f"n{i}" for i in range(200)]
    if metric == "hamming":
        data, qs, dim = words(rng, 200), words(rng, 20), 256
    else:
        data = rng.standard_normal((200, 16)).astype(np.float32)
        qs = rng.standard_normal((20, 16)).astype(np.float32)
        dim = 16
    h = T.HNSWIndex("h", T.IndexConfig(dim=dim, m=8, ef_construction=48,
                                       metric=metric, seed=5), device="cpu")
    f = TFlat("f", T.IndexConfig(dim=dim, metric=metric), device="cpu")
    for idx in (h, f):
        idx.add_batch(names, data)
    for idx, kw in ((h, dict(engine="scan-approx" if approx else "scan")),
                    (f, dict(approx=approx))):
        before = TS.CERT_STATS["queries"]
        with profiling.request():
            idx.search_batch(qs, 5, **kw)
        exact = int(profiling.recent(1)["exact_queries"][0])
        cert_queries = TS.CERT_STATS["queries"] - before
        table, vecs = (TS._scan_state(idx) if idx is h
                       else idx.scan_state())[:2]
        certified = TS.certified_serves(
            metric, int(table.shape[0]), int(table.shape[1]), approx=approx,
            tiered=table is not vecs)
        assert certified == (window == 8 and not approx)
        want = (20, 0) if certified else (0, 20 if dtype == "f32" else 0)
        assert (cert_queries, exact) == want
    assert seen == [window, window]
    assert TS.FETCH_WINDOW_FAST == 8


# -- the sharded index -------------------------------------------------------------

@pytest.fixture(scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_sharded_certified_hamming_scan(rng, monkeypatch, one_torch_thread,
                                        mesh):
    """The sharded twin over 8 CPU shards and a (2, 4) mesh: byte-equal
    to the exact sharded scan and to the JAX package's certified sharded
    scan; queries dead-centre on a 420-copy slab (~52 a shard, deeper
    than a shard's 40-deep selection) fall back through the exact sharded
    sink; CERT_STATS counts equal; recall_target=1.0 routes through the
    same tier."""
    n, k = 840, 10
    data = words(rng, n)
    data[300:720] = data[300]
    names = [f"h{i}" for i in range(n)]
    cfg = dict(dim=256, m=6, ef_construction=48, metric="hamming", seed=1)
    qs = np.concatenate([words(rng, 12), data[310:314]])
    meshes = ((jmesh(8), make_mesh(8, device="cpu")) if mesh == "1d" else
              (jmesh2d(2, 4), make_mesh2d(2, 4, device="cpu")))
    pair = []
    for cls, cfg_cls, m in ((JShard, J.IndexConfig, meshes[0]),
                            (TShard, T.IndexConfig, meshes[1])):
        idx = cls("csh", cfg_cls(**cfg), mesh=m)
        idx.add_batch(names, data, batch_size=256)
        pair.append(idx)
    want = exact_reply(monkeypatch, pair[1], qs, k, engine="scan")
    for kw in (dict(engine="scan"), dict(recall_target=1.0)):
        jr, tr, td, jd = served(pair, qs, k, **kw)
        same_cols(tr, want)
        same_cols(jr, tr, by_value=True)
        assert td == jd and td["batches"] == 1 and td["queries"] == 16
        assert td["fallback_queries"] >= 4
