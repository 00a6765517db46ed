"""The port's ShardedHNSW serving replies against the JAX package's.

The JAX ``ShardedHNSW`` runs on the 8-device virtual CPU mesh
(tests/conftest.py) and the port's on the CPU repeated 8 times
(``make_mesh(8, device="cpu")``), or on (2, 4) meshes of each. Both get
the same seeded rows, names, seeds and ``batch_size``, so the per-shard
graphs are the same (tests/test_torch_sharded.py holds them byte-equal)
and every engine's reply is compared: ``scan``, ``auto``,
``scan-approx``, ``graph`` with and without seeds, the certified tier
forced in its one-pass and two-pass forms, the bf16 and int8 tiers,
ids-only, columnar and object replies and ``search_knn`` (hamming
replies: tests/test_torch_sharded.py).

Integer-lattice rows make every f32 score exact, so ids are compared
byte for byte and sims bit for bit. On Gaussian rows ids are compared
byte for byte and sims within 1e-6 relative (the two packages' exact
direct-form sums may differ in the last ulps, ROADMAP.md section 3).
"""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu.ops.scan as JSC
import redis_hnsw_tpu_torch as T
import redis_hnsw_tpu_torch.ops.scan as TSC
import redis_hnsw_tpu_torch.ops.search as TSE
from redis_hnsw_tpu.parallel import ShardedHNSW as JShard
from redis_hnsw_tpu.parallel import make_mesh as jmesh
from redis_hnsw_tpu.parallel import make_mesh2d as jmesh2d
from redis_hnsw_tpu.parallel.sharded import (
    _merge_stacked_topk as jax_merge,
)
from redis_hnsw_tpu_torch.parallel import ShardedHNSW as TShard
from redis_hnsw_tpu_torch.parallel import make_mesh, make_mesh2d
from redis_hnsw_tpu_torch.parallel.sharded import (
    _merge_stacked_topk,
    _merge_topk_over,
)

GAUSS_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is many small per-shard ops: one intra-op thread
    keeps them cheap beside the JAX mesh's threads under a parallel test
    run (the previous count is restored)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lattice_rows(rng, n, dim):
    """Integer-lattice rows with a 6x duplicated slab: tie classes that a
    k = 10 cut truncates."""
    data = rng.integers(-4, 5, (n, dim)).astype(np.float32)
    data[300:600] = np.repeat(data[300:350], 6, axis=0)
    return data


def build(pkg_shard, cfg_cls, mesh, names, data, **cfg):
    idx = pkg_shard("sh", cfg_cls(**cfg), mesh=mesh)
    idx.add_batch(names, data, batch_size=128)
    return idx


def same_bits(ra, rb, label=""):
    assert np.array_equal(ra[0], rb[0]), label
    assert ra[1].shape == rb[1].shape, label
    assert np.array_equal(ra[1].view(np.int32), rb[1].view(np.int32)), label


def same_objects(oa, ob):
    assert [[(r.sim, r.name) for r in row] for row in oa] == [
        [(r.sim, r.name) for r in row] for row in ob]


@pytest.fixture(scope="module")
def lat():
    """A 840 x 16 lattice index on each side, 1-D meshes of 8, and a
    query block: 36 lattice points and 4 dead centres of the slab."""
    rng = np.random.default_rng(3)
    data = lattice_rows(rng, 840, 16)
    qs = np.concatenate(
        [rng.integers(-4, 5, (36, 16)).astype(np.float32), data[310:314]])
    names = [f"n{i}" for i in range(len(data))]
    cfg = dict(dim=16, m=6, ef_construction=48, seed=1)
    a = build(JShard, J.IndexConfig, jmesh(8), names, data, **cfg)
    b = build(TShard, T.IndexConfig, make_mesh(8, device="cpu"), names,
              data, **cfg)
    return a, b, data, qs


# -- the merge -------------------------------------------------------------------


@pytest.mark.parametrize("S,kk,k", [(8, 5, 10), (3, 4, 12), (4, 6, 1)])
def test_merge_equals_lax_top_k(S, kk, k):
    """The stable descending sort of the shard-major flattening is
    lax.top_k's merge: ties to the lower index, -inf slots last."""
    rng = np.random.default_rng(S * 100 + kk)
    sims = rng.integers(-3, 1, (S, 6, kk)).astype(np.float32)
    sims = -np.sort(-sims, axis=2)
    sims[:, :, -1:][rng.random((S, 6, 1)) < 0.5] = -np.inf
    gids = np.where(np.isinf(sims), -1, rng.integers(0, 99, (S, 6, kk)))
    gids = gids.astype(np.int32)
    jg, js = jax_merge(gids, sims, k)
    tg, ts = _merge_stacked_topk(torch.from_numpy(gids).long(),
                                 torch.from_numpy(sims), k)
    assert np.array_equal(np.asarray(jg), tg.numpy())
    assert np.array_equal(np.asarray(js).view(np.int32),
                          ts.numpy().view(np.int32))
    # innermost axis first over a (2, S/2)-shaped split gives the same
    if S % 2 == 0:
        parts = [(torch.from_numpy(gids[s]).long(), torch.from_numpy(sims[s]))
                 for s in range(S)]
        hg, hs = _merge_topk_over(parts, (2, S // 2), k)
        assert np.array_equal(hg.numpy(), tg.numpy())
        assert np.array_equal(hs.numpy(), ts.numpy())


def test_merge_wider_than_the_lists():
    """k > S * kk (a graph shard returns min(k, ef) columns): the port
    keeps all S * kk, where lax.top_k refuses."""
    gids = torch.arange(12).reshape(3, 1, 4)
    sims = -gids.float()
    g, s = _merge_stacked_topk(gids, sims, 40)
    assert g.shape == (1, 12) and g[0].tolist() == list(range(12))


# -- replies on every engine -------------------------------------------------------


ENGINES = [
    dict(engine="scan"),
    dict(engine="auto"),
    dict(engine="scan-approx"),
    dict(engine="graph"),
    dict(engine="graph", expand=4, seeds=4, ef_search=32),
    dict(engine="graph", expand=2, iters=3, ef_search=12, seeds=8),
    dict(engine="scan", k=1),
]


@pytest.mark.parametrize("kw", ENGINES, ids=lambda kw: str(sorted(kw.items())))
def test_lattice_replies_equal(lat, kw):
    a, b, _, qs = lat
    kw = dict(kw)
    k = kw.pop("k", 10)
    same_bits(a.search_batch(qs, k, reply="columnar", **kw),
              b.search_batch(qs, k, reply="columnar", **kw))
    same_objects(a.search_batch(qs, k, **kw), b.search_batch(qs, k, **kw))


def test_graph_k_beyond_the_shards_lists(lat):
    """k = 40 at ef 4: every shard returns 4 columns, and the port replies
    the 32 the JAX package gives at k = 32 (at k = 40 its merge
    refuses)."""
    a, b, _, qs = lat
    got = b.search_batch(qs, 40, engine="graph", ef_search=4,
                         reply="columnar")
    same_bits(a.search_batch(qs, 32, engine="graph", ef_search=4,
                             reply="columnar"), got)
    assert got[0].shape == (len(qs), 32)


@pytest.mark.parametrize("onepass", ["1", "0"])
@pytest.mark.parametrize("k", [1, 10])
def test_certified_equals_exact(lat, monkeypatch, onepass, k):
    """The certified tier forced (k = 1 takes the one-pass form, kernel
    D's plain version, at these 128-row shards; k = 10 the two-pass form
    either way): byte-equal to the JAX package's exact reply, with the
    JAX package's CERT_STATS counts, the slab's truncated tie classes
    served again through the exact sharded scan."""
    a, b, _, qs = lat
    want = a.search_batch(qs, k, engine="scan", reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", onepass)
    jb, tb = dict(JSC.CERT_STATS), dict(TSC.CERT_STATS)
    got = b.search_batch(qs, k, engine="scan", reply="columnar")
    same_bits(want, got)
    same_bits(a.search_batch(qs, k, engine="scan", reply="columnar"), got)
    deltas = [{key: st[key] - before[key] for key in
               ("batches", "queries", "fallback_queries")}
              for st, before in ((JSC.CERT_STATS, jb), (TSC.CERT_STATS, tb))]
    assert deltas[0] == deltas[1]
    assert deltas[1]["batches"] == 1 and deltas[1]["queries"] == len(qs)
    if k == 10:
        assert deltas[1]["fallback_queries"] > 0
    # recall_target=1.0 routes through the same certified path
    same_bits(want, b.search_batch(qs, k, recall_target=1.0,
                                   reply="columnar"))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_tiers_equal(lat, monkeypatch, dtype):
    """The tiers' scan equals the JAX package's, and scan-approx on a tier
    is the tier's exact select, as on one index (the JAX package's
    approx select is exact on the CPU)."""
    a, b, _, qs = lat
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
    got = b.search_batch(qs, 10, engine="scan", reply="columnar")
    same_bits(a.search_batch(qs, 10, engine="scan", reply="columnar"), got)
    same_bits(got, b.search_batch(qs, 10, engine="scan-approx",
                                  reply="columnar"))


@pytest.mark.parametrize("engine", ["scan", "graph"])
def test_ids_reply_equal(lat, monkeypatch, engine):
    """REDIS_HNSW_TPU_REPLY=ids-force: only the merged ids leave the
    devices and the sims are rescored on the host from the shards' row
    tables -- the JAX package's reply, and the port's full reply bit for
    bit."""
    a, b, _, qs = lat
    full = b.search_batch(qs, 10, engine=engine, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
    got = b.search_batch(qs, 10, engine=engine, reply="columnar")
    same_bits(a.search_batch(qs, 10, engine=engine, reply="columnar"), got)
    same_bits(full, got)


def test_search_knn_and_info_equal(lat):
    a, b, _, qs = lat
    for q in qs[::5]:
        same_objects([a.search_knn(q, 6)], [b.search_knn(q, 6)])
    assert a.info() == b.info()
    assert b.info()["n_shards"] == 8


def test_chunks_equal_one_chunk(lat, monkeypatch):
    """With the lane cap cut to 32, 100 queries span four chunks, the
    last one ragged: every engine's reply equals the one-chunk reply
    (which equals the JAX package's, above; the JAX package's own tests
    hold its chunks to its one chunk), and the certified tier counts one
    batch a chunk."""
    _, b, _, _ = lat
    qs = np.random.default_rng(9).integers(-4, 5, (100, 16)).astype(
        np.float32)
    engines = ("scan", "scan-approx", "graph")
    whole = {e: b.search_batch(qs, 7, engine=e, reply="columnar")
             for e in engines}
    monkeypatch.setattr(TSE, "MAX_LANES", 32)
    for engine in engines:
        same_bits(whole[engine],
                  b.search_batch(qs, 7, engine=engine, reply="columnar"),
                  engine)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    before = TSC.CERT_STATS["batches"]
    same_bits(whole["scan"],
              b.search_batch(qs, 7, engine="scan", reply="columnar"))
    assert TSC.CERT_STATS["batches"] == before + 4


def test_more_than_one_chunk_of_lanes(lat):
    """A 2,100-query block (more than 2,048 lanes) equals the same queries
    served in two calls."""
    _, b, _, _ = lat
    qs = np.random.default_rng(11).integers(-4, 5, (2100, 16)).astype(
        np.float32)
    for engine in ("scan", "graph"):
        kw = dict(engine=engine, reply="columnar", ef_search=8)
        whole = b.search_batch(qs, 5, **kw)
        parts = [b.search_batch(qs[:2048], 5, **kw),
                 b.search_batch(qs[2048:], 5, **kw)]
        same_bits(whole, tuple(np.concatenate([p[i] for p in parts])
                               for i in range(2)), engine)


# -- the 2-D mesh ------------------------------------------------------------------


@pytest.fixture(scope="module")
def lat2d(lat):
    """The same rows on (2, 4) meshes: the JAX package's hierarchical
    merge, and the port's innermost-axis-first merge."""
    _, _, data, qs = lat
    names = [f"n{i}" for i in range(len(data))]
    cfg = dict(dim=16, m=6, ef_construction=48, seed=1)
    a = build(JShard, J.IndexConfig, jmesh2d(2, 4), names, data, **cfg)
    b = build(TShard, T.IndexConfig, make_mesh2d(2, 4, device="cpu"),
              names, data, **cfg)
    return a, b


@pytest.mark.parametrize("kw", [
    dict(engine="scan"), dict(engine="graph", ef_search=32),
    dict(engine="graph", seeds=4, expand=4, ef_search=32),
    dict(engine="scan-approx"),
])
def test_2d_mesh_equals_1d(lat, lat2d, kw):
    _, b1, _, qs = lat
    _, b2 = lat2d
    same_bits(b1.search_batch(qs, 10, reply="columnar", **kw),
              b2.search_batch(qs, 10, reply="columnar", **kw))


@pytest.mark.parametrize("kw", [
    dict(engine="scan"), dict(engine="graph", seeds=4, expand=4,
                              ef_search=32),
])
def test_2d_mesh_equals_jax(lat2d, lat, kw):
    """The JAX package's hierarchical in-program merge and the port's
    innermost-axis-first merge give the same replies."""
    _, _, _, qs = lat
    a2, b2 = lat2d
    same_bits(a2.search_batch(qs, 10, reply="columnar", **kw),
              b2.search_batch(qs, 10, reply="columnar", **kw))


@pytest.mark.parametrize("onepass", ["1", "0"])
def test_2d_mesh_certified(lat, lat2d, monkeypatch, onepass):
    _, b1, _, qs = lat
    a2, b2 = lat2d
    want = a2.search_batch(qs, 10, engine="scan", reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", onepass)
    for k in (1, 10):
        got = b2.search_batch(qs, k, engine="scan", reply="columnar")
        same_bits(b1.search_batch(qs, k, engine="scan", reply="columnar"),
                  got)
    same_bits(want, got)


def test_2d_mesh_tiers_and_ids(lat, lat2d, monkeypatch):
    _, b1, _, qs = lat
    a2, b2 = lat2d
    for dtype in ("bf16", "int8"):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
        same_bits(b1.search_batch(qs, 10, engine="scan", reply="columnar"),
                  b2.search_batch(qs, 10, engine="scan", reply="columnar"))
    monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_DTYPE")
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
    same_bits(b1.search_batch(qs, 10, engine="graph", reply="columnar"),
              b2.search_batch(qs, 10, engine="graph", reply="columnar"))


# -- Gaussian rows ---------------------------------------------------------------------


def test_gaussian_replies_within_rounding():
    """Gaussian rows: ids byte-equal on the scan and the graph engine,
    sims within 1e-6 relative; a JAX index carried across by
    ``sharded_state`` / ``sharded_from_state`` (no file) serves the same
    replies as the port's own build."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal((800, 16)).astype(np.float32)
    qs = rng.standard_normal((40, 16)).astype(np.float32)
    names = [f"g{i}" for i in range(800)]
    cfg = dict(dim=16, m=8, ef_construction=48, seed=0)
    a = build(JShard, J.IndexConfig, jmesh(8), names, data, **cfg)
    b = build(TShard, T.IndexConfig, make_mesh(8, device="cpu"), names,
              data, **cfg)
    c = T.sharded_from_state(*T.sharded_state(a), device="cpu")
    for kw in (dict(engine="scan"),
               dict(engine="graph", seeds=8, ef_search=12, expand=2,
                    iters=3)):
        ra = a.search_batch(qs, 10, reply="columnar", **kw)
        for got in (b.search_batch(qs, 10, reply="columnar", **kw),
                    c.search_batch(qs, 10, reply="columnar", **kw)):
            assert np.array_equal(ra[0], got[0]), kw
            np.testing.assert_allclose(got[1], ra[1], rtol=GAUSS_RTOL)
