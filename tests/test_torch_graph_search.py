"""``search_batch(engine="graph")`` of the port against the JAX package,
on the CPU, and the graph engine's properties on Gaussian data.

Identical seeded lattice indexes (tests/test_torch_graph.py builds them)
serve identical query blocks: names and sims must be equal, sims
bitwise, for every frontier tier, through the "auto" route above a
lowered SCAN_MAX_ROWS, across MAX_LANES chunks and on an empty, a
one-node and a mutated index. The property checks (recall against a
float64 oracle, the ef knob, self queries, deletes) mirror
tests/test_search_device.py on the port alone.
"""

import numpy as np
import pytest

import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.ops import search as JS
from redis_hnsw_tpu_torch.ops import search as TS
from test_torch_graph import build_pair, lattice, pair, same_reply, set_tier

__all__ = ["pair"]  # the module-scoped lattice pair, built here anew


# -- search_batch --------------------------------------------------------------

@pytest.mark.parametrize(
    "kw",
    [dict(), dict(expand=16), dict(expand=4, seeds=4, ef_search=32),
     dict(expand=8, iters=3, ef_search=16), dict(k=40, ef_search=24),
     dict(expand=16, seeds=300, ef_search=64)],
)
def test_search_batch_graph_equal(pair, kw):
    a, b, data, qs = pair
    kw = dict(kw)
    k = kw.pop("k", 10)
    for block in (qs, data[::61] + 0.5):  # 37 and 5 queries: padded lanes
        ra = a.search_batch(block, k, engine="graph", reply="columnar", **kw)
        rb = b.search_batch(block, k, engine="graph", reply="columnar", **kw)
        same_reply(ra, rb)
        assert rb[0].shape == (len(block), min(k, kw.get("ef_search", 48)))


@pytest.mark.parametrize("tier", ["f16", "bf16", "off", "i8", "quant"])
def test_search_batch_graph_tiers(pair, monkeypatch, tier):
    """Every frontier tier serves the same replies as the JAX package
    (the int8 tiers' FMA-vs-rounded difference does not reach these
    lattice replies)."""
    a, b, _, qs = pair
    set_tier(monkeypatch, tier)
    a._snapshot = b._snapshot = None
    for kw in (dict(), dict(expand=16, seeds=4)):
        same_reply(
            a.search_batch(qs, 10, engine="graph", reply="columnar", **kw),
            b.search_batch(qs, 10, engine="graph", reply="columnar", **kw),
        )
    a._snapshot = b._snapshot = None


def test_search_batch_routes_and_chunks(pair, monkeypatch):
    """engine="auto" above a (lowered) SCAN_MAX_ROWS serves the graph
    engine, and a block larger than MAX_LANES is served in chunks."""
    a, b, data, qs = pair
    monkeypatch.setitem(JS.SCAN_MAX_ROWS, "euclidean", 64)
    monkeypatch.setitem(TS.SCAN_MAX_ROWS, "euclidean", 64)
    ra = a.search_batch(qs, 6, reply="columnar")
    rb = b.search_batch(qs, 6, reply="columnar")
    same_reply(ra, rb)
    same_reply(rb, b.search_batch(qs, 6, engine="graph", reply="columnar"))
    monkeypatch.setattr(JS, "MAX_LANES", 16)
    monkeypatch.setattr(TS, "MAX_LANES", 16)
    same_reply(a.search_batch(qs, 6, reply="columnar", expand=8),
               b.search_batch(qs, 6, reply="columnar", expand=8))
    oa = a.search_batch(qs[:5], 6, engine="graph")
    ob = b.search_batch(qs[:5], 6, engine="graph")
    assert [[(r.sim, r.name) for r in row] for row in oa] == [
        [(r.sim, r.name) for r in row] for row in ob]


def test_search_batch_graph_edges():
    """An empty index, a one-node index and an index after deletes."""
    rng = np.random.default_rng(6)
    data = lattice(rng, 60, 8)
    q = lattice(rng, 3, 8)
    a, b = build_pair(data[:0], m=4, efcon=16)
    for x in (a, b):
        assert x.search_batch(q, 3, engine="graph") == [[], [], []]
    same_reply(a.search_batch(q, 3, engine="graph", reply="columnar"),
               b.search_batch(q, 3, engine="graph", reply="columnar"))
    for x in (a, b):
        x.add_node("only", data[0])
    same_reply(a.search_batch(q, 3, engine="graph", reply="columnar"),
               b.search_batch(q, 3, engine="graph", reply="columnar"))
    assert [r.name for r in b.search_batch(q, 3, engine="graph")[0]] == [
        "only"]
    for i in range(1, 60):
        a.add_node(f"n{i}", data[i])
        b.add_node(f"n{i}", data[i])
    for i in range(1, 60, 3):
        a.delete_node(f"n{i}")
        b.delete_node(f"n{i}")
    same_reply(a.search_batch(q, 5, engine="graph", reply="columnar",
                              expand=4),
               b.search_batch(q, 5, engine="graph", reply="columnar",
                              expand=4))


# -- properties (Gaussian data, the port alone) ---------------------------------

@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(42)
    n, dim = 1500, 24
    data = rng.standard_normal((n, dim)).astype(np.float32)
    idx = T.HNSWIndex("dev", T.IndexConfig(dim=dim, m=8, ef_construction=64,
                                           seed=5), device="cpu")
    names = [f"n{i}" for i in range(n)]
    for i in range(n):
        idx.add_node(names[i], data[i])
    queries = rng.standard_normal((32, dim)).astype(np.float32)
    d = ((queries[:, None, :].astype(np.float64) - data[None]) ** 2).sum(-1)
    truth = [{names[j] for j in row} for row in np.argsort(d, 1)[:, :10]]
    return idx, data, queries, truth


def recall(res, truth):
    return sum(len({r.name for r in res[b]} & truth[b])
               for b in range(len(truth))) / (10 * len(truth))


def test_graph_recall_and_ef_knob(gauss):
    idx, _, queries, truth = gauss
    base = idx.search_batch(queries, 10, engine="graph")
    assert recall(base, truth) >= 0.95
    lo = idx.search_batch(queries, 10, ef_search=10, engine="graph")
    hi = idx.search_batch(queries, 10, ef_search=128, engine="graph")
    assert recall(hi, truth) >= recall(lo, truth)
    assert recall(hi, truth) >= 0.97
    wide = idx.search_batch(queries, 10, ef_search=128, expand=16,
                            iters=16, engine="graph")
    assert recall(wide, truth) >= 0.95
    for res in (base, hi, wide):
        for row in res:
            names = [r.name for r in row]
            sims = [r.sim for r in row]
            assert len(names) == len(set(names)) == 10
            assert sims == sorted(sims, reverse=True)


def test_graph_self_queries_and_padding(gauss):
    idx, data, _, _ = gauss
    res = idx.search_batch(data[7][None], k=1, engine="graph")
    assert res[0][0].name == "n7" and res[0][0].sim == 0.0
    res = idx.search_batch(data[:5], k=1, engine="graph")
    assert [r[0].name for r in res] == [f"n{i}" for i in range(5)]


def test_graph_after_deletes():
    rng = np.random.default_rng(3)
    n, dim = 300, 12
    data = rng.standard_normal((n, dim)).astype(np.float32)
    idx = T.HNSWIndex("d2", T.IndexConfig(dim=dim, m=4, ef_construction=32,
                                          seed=9), device="cpu")
    for i in range(n):
        idx.add_node(f"n{i}", data[i])
    idx.search_batch(data[:8], k=3, engine="graph")  # snapshot, then delta
    for i in range(0, n, 2):
        idx.delete_node(f"n{i}")
    surviving = {f"n{i}" for i in range(1, n, 2)}
    for r in idx.search_batch(data[:8], k=3, engine="graph", expand=4):
        assert r
        assert all(item.name in surviving for item in r)
