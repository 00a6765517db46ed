"""The JAX package's bulk-build tests (tests/test_core.py), held on the
port at the same floors, on the CPU: recall@10 >= 0.88 against the exact
scan, the reference's graph invariants, batch_size=1, hint-exact padding
across two add_batch calls, split == unsplit, scan-l0's recall and
invariants, scan-l0 py == native, and scan-l0's fallbacks. Graph
identities are bitwise (equal neighbour lists)."""

import numpy as np
import pytest

from redis_hnsw_tpu_torch import FlatIndex, HNSWIndex, IndexConfig
from redis_hnsw_tpu_torch.ops import construct as C


def make(name, **kw):
    return HNSWIndex(name, IndexConfig(**kw), device="cpu")


def recall_at(idx, data, queries, names, k):
    oracle = FlatIndex("o", IndexConfig(dim=data.shape[1]), device="cpu")
    oracle.add_batch(names, data)
    truth = [{r.name for r in t} for t in oracle.search_batch(queries, k)]
    res = idx.search_batch(queries, k, ef_search=100, engine="graph")
    hits = sum(len({r.name for r in rr} & truth[b])
               for b, rr in enumerate(res))
    return hits / (k * len(queries))


def graph_invariants(idx):
    """Symmetric links, degree caps, no self or dangling links, one list
    per layer up to the row's level."""
    for row in range(idx._names.high_water):
        if not idx._is_alloc(row):
            continue
        lists = idx._layer_lists(row)
        assert len(lists) == idx._levels[row] + 1
        for lc, nbrs in enumerate(lists):
            cap = idx.config.m_max_0 if lc == 0 else idx.config.m_max
            assert len(nbrs) <= cap, (row, lc, len(nbrs))
            assert len(set(nbrs)) == len(nbrs)
            for nb in nbrs:
                assert nb != row and idx._is_alloc(nb)
                assert row in idx._nbrs(nb, lc), (row, nb, lc)


def same_graph(a, b):
    assert a.max_layer == b.max_layer
    assert a.enterpoint == b.enterpoint
    for row in range(a._names.high_water):
        assert a._levels[row] == b._levels[row]
        for lc in range(int(a._levels[row]) + 1):
            assert sorted(a._nbrs(row, lc)) == sorted(b._nbrs(row, lc)), (
                row, lc)


@pytest.mark.parametrize("l0", ["auto", "beam"])
def test_bulk_build_recall(rng, monkeypatch, l0):
    """Wave construction reaches recall@10 >= 0.88 at M=8, efcon=100
    (test_core.py:207), on the default scan-l0 path and on the beam."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", l0)
    n, dim, k = 1500, 32, 10
    data = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((64, dim)).astype(np.float32)
    names = [f"n{i}" for i in range(n)]
    idx = make("b", dim=dim, m=8, ef_construction=100, seed=3)
    idx.add_batch(names, data, batch_size=512)
    assert idx.node_count == n
    rec = recall_at(idx, data, queries, names, k)
    assert rec >= 0.88, f"bulk recall@{k} = {rec}"


def test_bulk_build_graph_invariants(rng):
    """test_core.py:235: invariants, and every node in exactly one layer
    set, at its level."""
    n, dim = 400, 16
    data = rng.standard_normal((n, dim)).astype(np.float32)
    idx = make("g", dim=dim, m=6, ef_construction=60, seed=5)
    idx.add_batch([f"n{i}" for i in range(n)], data, batch_size=128)
    graph_invariants(idx)
    seen = set()
    for lc, s in enumerate(idx._layer_sets):
        for row in s:
            assert row not in seen
            assert idx._levels[row] == lc
            seen.add(row)
    assert len(seen) == n


def test_bulk_vs_sequential_equivalence_small(rng):
    """test_core.py:266: batch_size=1 builds a searchable graph."""
    n, dim = 60, 8
    data = rng.standard_normal((n, dim)).astype(np.float32)
    idx = make("a", dim=dim, m=4, ef_construction=30, seed=9)
    idx.add_batch([f"n{i}" for i in range(n)], data, batch_size=1)
    assert idx.node_count == n
    res = idx.search_knn(data[7], 1)
    assert res[0].name == "n7"
    assert res[0].sim == 0.0


def test_hint_exact_padding(rng):
    """test_core.py:348: rows pad to the capacity hint rounded to 128,
    and never shrink when a second add_batch grows past it."""
    dim, n = 8, 300
    data = rng.standard_normal((n, dim)).astype(np.float32)
    idx = make("p", dim=dim, m=4, ef_construction=16, seed=0, capacity=1)
    idx._capacity_hint = 1200
    idx.add_batch([f"n{i}" for i in range(n)], data, batch_size=128)
    assert idx.device_snapshot().n_pad == 1280
    more = rng.standard_normal((1100, dim)).astype(np.float32)
    idx.add_batch([f"m{i}" for i in range(1100)], more, batch_size=512)
    snap2 = idx.device_snapshot()
    assert snap2.n_pad >= 1400 and snap2.n_pad % 128 == 0
    res = idx.search_batch(data[:4], k=3, engine="graph")
    assert res[0][0].name == "n0"


def test_wave_split_builds_identical_graph(rng, monkeypatch):
    """test_core.py:461: split upper beams build the graph of the
    full-width layer loop."""
    n, dim = 1200, 24
    data = rng.standard_normal((n, dim)).astype(np.float32)
    names = [f"n{i}" for i in range(n)]

    def build(split):
        monkeypatch.setenv("REDIS_HNSW_TPU_WAVE_SPLIT", split)
        monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", "beam")
        idx = make("ws", dim=dim, m=8, ef_construction=64, seed=5)
        idx.add_batch(names, data, batch_size=512)
        return idx

    same_graph(build("0"), build("1"))


def test_scan_l0_build_recall_and_invariants(rng, monkeypatch):
    """test_core.py:494: scan-l0 waves reach the beam path's recall bar
    and keep the graph invariants."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", "scan")
    n, dim, k = 1500, 32, 10
    data = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((64, dim)).astype(np.float32)
    names = [f"n{i}" for i in range(n)]
    idx = make("b", dim=dim, m=8, ef_construction=100, seed=3)
    idx.add_batch(names, data, batch_size=512)
    assert idx.node_count == n
    rec = recall_at(idx, data, queries, names, k)
    assert rec >= 0.88, f"scan-l0 bulk recall@{k} = {rec}"
    graph_invariants(idx)


def test_scan_l0_py_native_identical(rng, monkeypatch):
    """test_core.py:533: both backends consume the same scan-sourced
    candidate arrays, so the graphs are identical."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", "scan")
    n, dim = 1200, 24
    data = rng.standard_normal((n, dim)).astype(np.float32)
    names = [f"n{i}" for i in range(n)]

    def build(native):
        idx = make("x", dim=dim, m=8, ef_construction=64, seed=5)
        if not native:
            idx._native = None
        idx.add_batch(names, data, batch_size=512)
        return idx

    a, b = build(True), build(False)
    assert a._native is not None
    same_graph(a, b)


def test_scan_l0_fallbacks(rng, monkeypatch):
    """test_core.py:564: hamming builds and tiny snapshots stay on the
    beam path with scan forced; deletes refresh the build live mask, so
    freed rows are never linked."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", "scan")
    h = make("h", dim=64, m=5, ef_construction=32, seed=2, metric="hamming")
    hdata = rng.integers(0, 2**32, (120, 2)).astype(np.uint32)
    h.add_batch([f"h{i}" for i in range(120)], hdata, batch_size=64)
    assert h.node_count == 120
    assert not C._build_l0_scan(h, h.device_snapshot(), 32)

    idx = make("c", dim=16, m=6, ef_construction=40, seed=7)
    idx._capacity_hint = 4096
    d = rng.standard_normal((500, 16)).astype(np.float32)
    idx.add_batch([f"c{i}" for i in range(500)], d, batch_size=256)
    assert C._build_l0_scan(idx, idx.device_snapshot(), 32)
    assert not C._build_l0_scan(idx, idx.device_snapshot(), 1 << 13)
    for i in range(100):
        idx.delete_node(f"c{i}")
    idx.add_batch(
        [f"d{i}" for i in range(200)],
        rng.standard_normal((200, 16)).astype(np.float32),
        batch_size=128,
    )
    assert idx.node_count == 600
    # delete repair may leave degrees over the caps (core.rs:824-863), so
    # only liveness is asserted here, as test_core.py does
    for row in range(idx._names.high_water):
        if idx._is_alloc(row):
            for lc, nbrs in enumerate(idx._layer_lists(row)):
                assert all(idx._is_alloc(nb) for nb in nbrs), (row, lc)
