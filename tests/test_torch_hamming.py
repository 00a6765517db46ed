"""The hamming metric of the port against the JAX package, on the CPU.

Packed bit rows (random uint32 words, high bit included) go through
``redis_hnsw_tpu`` and ``redis_hnsw_tpu_torch``: the distance functions,
kernel A′'s plain version (against the Pallas kernel in interpret mode),
``search_batch`` on the scan and graph engines and on the flat kind, and
both packages' certified hamming tiers under SCAN_CERT=1 (their replies,
and their CERT_STATS counts; tests/test_torch_cert_hamming.py holds the
rest of that tier). Hamming scores are
integers, exact in f32 on any data, so every comparison is exact: ids and
names equal, sims equal. Where both packages encode a zero distance the
same way the sims are compared byte for byte; the JAX package's flat
exact tier and Pallas path give a zero distance as +0.0 where its
word-packed replies and the port give -0.0, so those compare by value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu.ops.scan as JS
import redis_hnsw_tpu_torch as T
import redis_hnsw_tpu_torch.ops.scan as TS
import redis_hnsw_tpu_torch.ops.search as TSearch
from redis_hnsw_tpu.models.flat import FlatIndex as JFlat
from redis_hnsw_tpu.ops import distance as JD
from redis_hnsw_tpu.ops.pallas_scan import flat_topk_pallas, hamming_bias
from redis_hnsw_tpu_torch.models.flat import FlatIndex as TFlat
from redis_hnsw_tpu_torch.ops import cuda_scan
from redis_hnsw_tpu_torch.ops import distance as TD


def words(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def tw(a):
    """uint32 words as the port's int32 tensor (same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def same(ra, rb, by_value=False):
    """Columnar replies: names equal; sims equal byte for byte (or by
    value where the packages encode a zero distance differently)."""
    assert np.array_equal(ra[0], rb[0])
    if by_value:
        assert np.array_equal(ra[1], rb[1])
    else:
        assert np.array_equal(ra[1].view(np.int32), rb[1].view(np.int32))


# -- distance functions ---------------------------------------------------------

@pytest.mark.parametrize("w", [1, 3, 8])
def test_distance_functions_match_jax(rng, w):
    q = words(rng, 6, w)
    x = words(rng, 50, w)
    x[7] = q[2]  # distance 0: -0.0 in both packages
    x[8] = ~q[3]  # every bit differs
    got = TD.pairwise_hamming(tw(q), tw(x)).numpy()
    want = np.asarray(JD.pairwise_hamming(jnp.asarray(q), jnp.asarray(x)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[3, 8] == -32 * w
    assert np.array_equal(got, TD.hamming_np(q[:, None, :], x[None]))

    nbrvec = words(rng, 20 * 5, w).reshape(20, 5, w)
    cand = rng.integers(0, 20, (6, 3)).astype(np.int32)
    mask = rng.random((6, 15)) > 0.3
    got = TD.block_hamming(tw(q), tw(nbrvec), torch.from_numpy(cand),
                           torch.from_numpy(mask)).numpy()
    want = JD.block_hamming(jnp.asarray(q), jnp.asarray(nbrvec),
                            jnp.asarray(cand), jnp.asarray(mask))
    assert np.array_equal(got.view(np.int32), np.asarray(want).view(np.int32))

    ids = rng.integers(0, 50, (6, 9)).astype(np.int32)
    ids[2, 0] = 7
    mask = rng.random((6, 9)) > 0.3
    mask[2, 0] = True
    got = TD.frontier_hamming(tw(q), tw(x), torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    want = JD.frontier_hamming(jnp.asarray(q), jnp.asarray(x),
                               jnp.asarray(ids), jnp.asarray(mask))
    assert np.array_equal(got.view(np.int32), np.asarray(want).view(np.int32))
    assert got[2, 0] == 0 and np.signbit(got[2, 0])


# -- kernel A′ (plain version) ----------------------------------------------------

@pytest.mark.parametrize("B,N,W,k", [(40, 500, 8, 7), (9, 300, 3, 32),
                                     (5, 64, 1, 1), (6, 400, 3, 257),
                                     (4, 450, 3, 300)])
def test_plain_topk_hamming_matches_pallas(rng, B, N, W, k):
    """Exact ids and sims (ties to the lowest id), zero distance and
    dead rows included, as the Pallas kernel computes them."""
    q = words(rng, B, W)
    v = words(rng, N, W)
    v[N // 2] = q[0]
    v[N // 3] = v[N // 2]
    valid = rng.random(N) > 0.15
    valid[N // 2] = valid[N // 3] = True
    ji, js = flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(v), hamming_bias(jnp.asarray(valid)),
        k=k, metric="hamming", interpret=True,
    )
    bias = cuda_scan.hamming_bias(torch.from_numpy(valid))
    ti, ts = cuda_scan.flat_topk_hamming(tw(q), tw(v), bias, k=k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ts.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    assert ti[0, 0] == N // 3 and ts[0, 0] == 0


def test_check_words_rejects():
    q = torch.zeros((2, 3), dtype=torch.int32)
    x = torch.zeros((5, 3), dtype=torch.int32)
    bias = torch.zeros(5)
    with pytest.raises(TypeError):
        cuda_scan.flat_topk_hamming(q.float(), x, bias, k=1)
    # no width limit: k = 257 is served, padded past the 5 rows
    ids, sims = cuda_scan.flat_topk_hamming(q, x, bias, k=257)
    assert ids.shape == sims.shape == (2, 257)
    assert (ids[:, 5:] == -1).all() and torch.isinf(sims[:, 5:]).all()
    with pytest.raises(ValueError, match="width"):
        cuda_scan.flat_topk_hamming(q[:, :2], x, bias, k=1)


# -- search_batch ---------------------------------------------------------------

def hnsw_pair(data, m=8, efcon=48):
    dim = 32 * data.shape[1]
    a = J.HNSWIndex("h", J.IndexConfig(dim=dim, m=m, ef_construction=efcon,
                                       metric="hamming", seed=5))
    b = T.HNSWIndex("h", T.IndexConfig(dim=dim, m=m, ef_construction=efcon,
                                       metric="hamming", seed=5),
                    device="cpu")
    for i, row in enumerate(data):
        a.add_node(f"n{i}", row)
        b.add_node(f"n{i}", row)
    return a, b


@pytest.fixture(scope="module")
def hpair():
    """One hamming HNSW index on each side, 500 x 256 bits with deletes,
    and a query block holding exact copies of live and deleted rows."""
    rng = np.random.default_rng(31)
    data = words(rng, 500, 8)
    data[200:204] = data[100]  # a tie class at every distance to row 100
    a, b = hnsw_pair(data)
    for i in range(0, 500, 9):
        a.delete_node(f"n{i}")
        b.delete_node(f"n{i}")
    qs = words(rng, 37, 8)
    qs[0] = data[100]  # live copies: distance 0
    qs[1] = data[9]  # a deleted row's copy
    return a, b, data, qs


@pytest.mark.parametrize("engine", ["scan", "auto"])
def test_search_batch_scan_matches_jax(hpair, engine):
    a, b, _, qs = hpair
    for k in (10, 1, 40):
        same(a.search_batch(qs, k, engine=engine, reply="columnar"),
             b.search_batch(qs, k, engine=engine, reply="columnar"))
    ra = b.search_batch(qs[:3], 5, engine=engine)
    assert ra[0][0].sim == 0 and ra[0][0].name == "n100"
    assert [r.name for r in ra[0][1:5]] == ["n200", "n201", "n202", "n203"]


@pytest.mark.parametrize("tier", ["f32", "off"])
@pytest.mark.parametrize("kw", [dict(), dict(expand=16), dict(seeds=4),
                                dict(expand=16, seeds=4)])
def test_search_batch_graph_matches_jax(hpair, monkeypatch, tier, kw):
    """The graph engine with the packed-word blocks ("f32" forces blocks;
    a hamming table's blocks are its words) and with row gathers."""
    a, b, _, qs = hpair
    monkeypatch.setenv("REDIS_HNSW_TPU_NBRVEC_DTYPE", tier)
    a._snapshot = b._snapshot = None
    try:
        same(a.search_batch(qs, 10, engine="graph", reply="columnar", **kw),
             b.search_batch(qs, 10, engine="graph", reply="columnar", **kw))
        snap = b.device_snapshot()
        assert (snap.nbrvec is None) == (tier == "off")
        assert snap.nbrvec is None or snap.nbrvec.dtype == torch.int32
    finally:
        a._snapshot = b._snapshot = None


def test_search_batch_graph_auto_route_and_chunks(hpair, monkeypatch):
    a, b, _, qs = hpair
    import redis_hnsw_tpu.ops.search as JSearch

    monkeypatch.setitem(JSearch.SCAN_MAX_ROWS, "hamming", 64)
    monkeypatch.setitem(TSearch.SCAN_MAX_ROWS, "hamming", 64)
    monkeypatch.setattr(JSearch, "MAX_LANES", 16)
    monkeypatch.setattr(TSearch, "MAX_LANES", 16)
    got = b.search_batch(qs, 6, reply="columnar", expand=8)
    same(a.search_batch(qs, 6, reply="columnar", expand=8), got)
    same(got, b.search_batch(qs, 6, engine="graph", reply="columnar",
                             expand=8))


@pytest.mark.parametrize("cert", ["0", "1"])
def test_flat_matches_jax(rng, monkeypatch, cert):
    """The flat kind on the default route (exact or certified tier) and
    with use_pallas=True (kernel A′ over the whole block)."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", cert)
    data = words(rng, 900, 3)
    qs = words(rng, 21, 3)
    qs[0] = data[11]
    names = [f"n{i}" for i in range(900)]
    a = JFlat("f", J.IndexConfig(dim=96, metric="hamming"))
    b = TFlat("f", T.IndexConfig(dim=96, metric="hamming"), device="cpu")
    a.add_batch(names, data)
    b.add_batch(names, data)
    a.delete_batch(names[::5])
    b.delete_batch(names[::5])
    got = b.search_batch(qs, 10, reply="columnar")
    same(a.search_batch(qs, 10, reply="columnar"), got, by_value=True)
    pallas = b.search_batch(qs, 10, reply="columnar", use_pallas=True)
    same(a.search_batch(qs, 10, reply="columnar", use_pallas=True), pallas,
         by_value=True)
    same(got, pallas)  # the port's tiers agree byte for byte
    assert got[0][0, 0] == "n11" and np.signbit(got[1][0, 0])
    objs = b.search_batch(qs[:2], 4)
    assert [r.name for r in objs[0]] == got[0][0, :4].tolist()


# -- SCAN_CERT=1: both packages' certified hamming tiers --------------------------

CERT_KEYS = ("batches", "queries", "fallback_queries")


def cert_delta(stats, before):
    return {key: stats[key] - before[key] for key in CERT_KEYS}


def cert_pair(data):
    names = [f"n{i}" for i in range(len(data))]
    a = JFlat("f", J.IndexConfig(dim=32 * data.shape[1], metric="hamming"))
    b = TFlat("f", T.IndexConfig(dim=32 * data.shape[1], metric="hamming"),
              device="cpu")
    a.add_batch(names, data)
    b.add_batch(names, data)
    return a, b


def test_certified_hamming_matches_exact_and_jax(rng, monkeypatch):
    """SCAN_CERT=1: both packages serve their certified hamming tiers,
    replies equal to the exact tier's byte for byte, on the flat kind and
    the HNSW scan route (recall_target=1.0 too), and each batch counted
    in CERT_STATS as the JAX package counts it."""
    a, b = cert_pair(words(rng, 600, 8))
    hidx = hnsw_pair(words(rng, 300, 8))
    qs = words(rng, 32, 8)
    want = b.search_batch(qs, 10, reply="columnar")
    hwant = hidx[1].search_batch(qs, 10, engine="scan", reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    tb, jb = dict(TS.CERT_STATS), dict(JS.CERT_STATS)
    got = b.search_batch(qs, 10, reply="columnar")
    same(got, want)
    same(a.search_batch(qs, 10, reply="columnar"), got)
    hgot = hidx[1].search_batch(qs, 10, engine="scan", reply="columnar")
    same(hgot, hwant)
    same(hidx[0].search_batch(qs, 10, engine="scan", reply="columnar"), hgot)
    rt = hidx[1].search_batch(qs, 10, recall_target=1.0, reply="columnar")
    same(rt, hwant)
    same(hidx[0].search_batch(qs, 10, recall_target=1.0, reply="columnar"),
         rt)
    delta = cert_delta(TS.CERT_STATS, tb)
    assert delta == cert_delta(JS.CERT_STATS, jb)
    assert delta["batches"] == 3 and delta["queries"] == 96


def test_certified_hamming_straddling_ties_certify(rng, monkeypatch):
    """Every row duplicated 8x, k = 10: the tie class at the 10th
    distance straddles the k boundary but fits in the 4k selection, so
    both packages' certified tiers certify every query; the replies are
    equal, lowest ids of the class first."""
    a, b = cert_pair(np.repeat(words(rng, 60, 8), 8, axis=0))
    qs = words(rng, 16, 8)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    tb, jb = dict(TS.CERT_STATS), dict(JS.CERT_STATS)
    got = b.search_batch(qs, 10, reply="columnar")
    same(a.search_batch(qs, 10, reply="columnar"), got)
    delta = cert_delta(TS.CERT_STATS, tb)
    assert delta == cert_delta(JS.CERT_STATS, jb)
    assert delta["queries"] == 16 and delta["fallback_queries"] == 0
    rows = np.vectorize(lambda nm: int(nm[1:]))(got[0])
    d = -got[1]
    for r, dist in zip(rows, d):
        # within a tie class of distances the rows ascend
        assert all(r[i] < r[i + 1] for i in range(9) if dist[i] == dist[i + 1])


def test_certified_hamming_oversized_tie_falls_back(rng, monkeypatch):
    """A tie class of 48 copies at distance 0, larger than the 40-deep
    selection: both packages' certified tiers fall back for every query
    and serve the lowest ids of the class."""
    base = words(rng, 12, 8)
    a, b = cert_pair(np.repeat(base, 48, axis=0))
    qs = base[:8].copy()
    want = b.search_batch(qs, 10, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    tb, jb = dict(TS.CERT_STATS), dict(JS.CERT_STATS)
    got = b.search_batch(qs, 10, reply="columnar")
    same(got, want)
    same(a.search_batch(qs, 10, reply="columnar"), got)
    delta = cert_delta(TS.CERT_STATS, tb)
    assert delta == cert_delta(JS.CERT_STATS, jb)
    assert delta["fallback_queries"] == 8
    assert got[0][1].tolist() == [f"n{48 + i}" for i in range(10)]


def test_certified_hamming_deletes_and_edges(rng, monkeypatch):
    """Deletes stay masked; k above the live rows; oversized tie classes
    across 8-query chunks: equal to the JAX package's certified tier, the
    one uncertified query of each chunk deferred to the rerun sink with
    the exact hamming tier as its rerun, as in the JAX package."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    data = words(rng, 300, 8)
    a, b = cert_pair(data)
    names = [f"n{i}" for i in range(300)]
    a.delete_batch(names[::2])
    b.delete_batch(names[::2])
    got = b.search_batch(data[:8], 5, reply="columnar")
    assert set(got[0].ravel()) <= set(names[1::2])
    same(a.search_batch(data[:8], 5, reply="columnar"), got)
    sa, sb = cert_pair(data[:12])
    for ra, rb in zip(sa.search_batch(data[:2], 40), sb.search_batch(data[:2],
                                                                    40)):
        assert len(rb) == 12
        assert [(r.sim, r.name) for r in ra] == [(r.sim, r.name) for r in rb]

    base = words(rng, 400, 8)
    big = np.concatenate([base, np.repeat(base[:3], 60, axis=0)])
    ja, c = cert_pair(big)
    qs = words(rng, 24, 8)
    qs[::8] = base[:3]  # one oversized tie class per 8-query chunk
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "0")
    want = c.search_batch(qs, 10, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setattr(TSearch, "MAX_LANES", 8)
    added = []
    real_add = TS.CertRerunSink.add

    def add(self, exact, qd, bad, *rest):
        added.append((len(bad), exact.func is TS.scan_topk_exact_hamming))
        return real_add(self, exact, qd, bad, *rest)

    monkeypatch.setattr(TS.CertRerunSink, "add", add)
    got = c.search_batch(qs, 10, reply="columnar")
    same(got, want)
    jb = dict(JS.CERT_STATS)
    same(ja.search_batch(qs, 10, reply="columnar"), got)
    # every chunk holds an oversized tie class: each defers its
    # uncertified rows (a quarter or fewer) for the exact hamming tier
    assert len(added) == 3 and all(ham for _, ham in added)
    assert sum(n for n, _ in added) == cert_delta(JS.CERT_STATS, jb)[
        "fallback_queries"]


# -- the two repairs --------------------------------------------------------------

def test_pad_queries_keeps_words(rng):
    """Packed query words keep their bits through pad_queries (they
    used to be cast to float32)."""
    q = words(rng, 5, 3)
    q[0, 0] = 0xFFFFFFFF
    qd = TS.pad_queries(q, 8, "cpu")
    assert qd.dtype == torch.int32 and qd.shape == (8, 3)
    assert np.array_equal(qd[:5].numpy().view(np.uint32), q)
    assert not qd[5:].any()
    assert TS.pad_queries(tw(q), 5, "cpu").dtype == torch.int32
    f = TS.pad_queries(rng.standard_normal((3, 4)), 4, "cpu")
    assert f.dtype == torch.float32


def test_flat_hamming_upload(rng):
    """The flat kind uploads its packed words as int32, bytes intact,
    with zero sqnorms."""
    data = words(rng, 130, 2)
    data[0] = 0xFFFFFFFF
    b = TFlat("f", T.IndexConfig(dim=64, metric="hamming"), device="cpu")
    b.add_batch([f"n{i}" for i in range(130)], data)
    vecs, sqn, valid, tscale = b._device()
    assert vecs.dtype == torch.int32 and vecs.shape == (256, 2)
    assert np.array_equal(vecs[:130].numpy().view(np.uint32), data)
    assert not sqn.any() and int(valid.sum()) == 130 and tscale is None
