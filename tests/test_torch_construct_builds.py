"""Bulk builds of the port against the JAX package, on the CPU:
``add_batch`` of the same lattice rows builds the same graph -- every
row's neighbour list at every layer, in order, with levels, enterpoint
and max_layer -- on both host backends, under
``REDIS_HNSW_TPU_BUILD_L0`` = scan and beam, ``REDIS_HNSW_TPU_WAVE_SPLIT``
= 0 and 1, and batch sizes 1, 32 and 128 with a partial trailing wave;
and the snapshot deltas between waves, which copy a wave's vectors from
its query block on the device, byte-equal to a full rebuild. Tolerance:
none (integer-lattice rows make every f32 score exact)."""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu_torch.ops.snapshot import build_snapshot
from test_torch_construct import (
    EFCON,
    M,
    SEED,
    assert_same_graph,
    index_pair,
    lattice,
)


BUILDS = [
    # backend, REDIS_HNSW_TPU_BUILD_L0, REDIS_HNSW_TPU_WAVE_SPLIT, batch
    ("native", "scan", "1", 128),
    ("native", "beam", "1", 32),
    ("native", "beam", "0", 128),
    ("py", "scan", "0", 32),
    ("py", "beam", "1", 128),
    ("native", "scan", "1", 1),
    ("py", "beam", "0", 1),
]


@pytest.mark.parametrize("backend,l0,split,batch", BUILDS)
def test_bulk_build_graph_identical(monkeypatch, backend, l0, split, batch):
    """A lattice bulk build equals the JAX package's build. 299 rows
    after the first make a partial trailing wave at 32 and 128; batch 1
    builds 59 one-row waves."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", l0)
    monkeypatch.setenv("REDIS_HNSW_TPU_WAVE_SPLIT", split)
    n = 60 if batch == 1 else 300
    data = lattice(np.random.default_rng(batch), n, 16)
    names = [f"n{i}" for i in range(n)]
    a, b = index_pair(16, native=backend == "native")
    assert (b._native is None) == (backend == "py")
    a.add_batch(names, data, batch_size=batch)
    b.add_batch(names, data, batch_size=batch)
    assert b.node_count == n and b.max_layer >= 1
    assert_same_graph(a, b)




MUTATED_BUILDS = [
    # backend, REDIS_HNSW_TPU_BUILD_L0
    ("native", "scan"),
    ("native", "beam"),
    ("py", "scan"),
    ("py", "beam"),
]


@pytest.mark.parametrize("backend,l0", MUTATED_BUILDS)
def test_bulk_build_after_mutations_graph_identical(monkeypatch, backend,
                                                    l0):
    """A bulk build onto an index that ``add_node`` grew, deletes thinned
    (the enterpoint among them) and a search left a cached snapshot
    and scan state of, equals the JAX package's build -- the path a
    restored index's staged build and the stream's waves take."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", l0)
    data = lattice(np.random.default_rng(5), 260, 16)
    names = [f"n{i}" for i in range(260)]
    a, b = index_pair(16, native=backend == "native")
    for x in (a, b):
        for i in range(80):
            x.add_node(names[i], data[i])
        x.delete_node(x._names.name(x.enterpoint))
        for i in range(1, 80, 9):
            if names[i] in x:
                x.delete_node(names[i])
        x.search_batch(data[:16], 5, engine="scan")
        x.search_batch(data[:16], 5, engine="graph", ef_search=24)
        x.add_batch(names[80:200], data[80:200], batch_size=32)
        x.delete_batch([names[i] for i in range(80, 200, 11)])
        x.search_batch(data[:16], 5)
        x.add_batch(names[200:], data[200:], batch_size=48)
    assert_same_graph(a, b)
    assert b.node_count == a.node_count


# -- the device-side wave scatter ------------------------------------------------

SNAP_FIELDS = ("vecs", "sqnorms", "adj0", "adj_up", "upper_of", "nbrvec",
               "nbrsqn", "qrows")


def assert_snapshot_is_full_rebuild(b):
    """The port's delta-refreshed snapshot is byte-equal to a full
    rebuild of the same index, every table the deltas derive from the
    vectors (sqnorms, neighbour blocks, quantized rows) included."""
    snap = b.device_snapshot()
    full = build_snapshot(b)
    for field in SNAP_FIELDS:
        got, want = getattr(snap, field), getattr(full, field)
        assert (got is None) == (want is None), field
        if got is not None:
            assert got.dtype == want.dtype and torch.equal(got, want), field
    assert (snap.ep, snap.max_layer, snap.n_pad) == (
        full.ep, full.max_layer, full.n_pad)


def wave_rows(metric, n, seed):
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        return 96, rng.integers(0, 2**32, (n, 3), dtype=np.uint32)
    return 16, lattice(rng, n, 16)


def presized_pair(dim, metric, native=True):
    """An index on each side presized to 2048 rows, so that the snapshot's
    shapes hold and every refresh after the first is a delta."""
    kw = dict(dim=dim, m=M, ef_construction=EFCON, seed=SEED, metric=metric,
              capacity=2048)
    a = J.HNSWIndex("c", J.IndexConfig(**kw))
    b = T.HNSWIndex("c", T.IndexConfig(**kw), device="cpu")
    if not native:
        a._native = b._native = None
    return a, b


@pytest.mark.parametrize("backend,metric,quant", [
    ("native", "euclidean", "0"), ("py", "euclidean", "0"),
    ("native", "euclidean", "1"), ("native", "hamming", "0"),
    ("py", "hamming", "0"),
])
def test_wave_deltas_take_the_device_path(monkeypatch, backend, metric,
                                          quant):
    """After ``add_batch`` every wave's snapshot delta copies the wave's
    vectors on the device (the query block), none uploads them; the
    snapshot is byte-equal to a full rebuild (with the int8 row table
    under REDIS_HNSW_TPU_QUANT=1 too), and the graph and replies equal
    the JAX package's."""
    monkeypatch.setenv("REDIS_HNSW_TPU_QUANT", quant)
    dim, data = wave_rows(metric, 300, 17)
    names = [f"n{i}" for i in range(len(data))]
    a, b = presized_pair(dim, metric, native=backend == "native")
    a.add_batch(names, data, batch_size=64)
    b.add_batch(names, data, batch_size=64)
    b.device_snapshot()  # the last wave's delta
    # five waves, then the search's refresh: six, the first built in
    # full (and one more where the graph outgrows the presized layer
    # stack), every delta by the device path
    r = b.snapshot_refreshes
    assert r["full"] + r["delta"] == 6 and r["delta"] >= 4
    assert r["delta_device"] == r["delta"]
    assert (b.device_snapshot().qrows is not None) == (quant == "1")
    assert_snapshot_is_full_rebuild(b)
    assert_same_graph(a, b)
    qs = data[:16]
    ra = a.search_batch(qs, 5, engine="scan", reply="columnar")
    rb = b.search_batch(qs, 5, engine="scan", reply="columnar")
    assert np.array_equal(ra[0], rb[0]) and np.array_equal(ra[1], rb[1])


@pytest.mark.parametrize("metric", ["euclidean", "hamming"])
def test_wave_delta_after_add_node_or_delete(metric):
    """An ``add_node`` between two builds adds a row the last wave's
    block does not hold: that delta uploads from the host. A delete
    changes no vector: the next delta still copies the wave's block.
    Snapshots stay byte-equal to a full rebuild, the graph the JAX
    package's."""
    dim, data = wave_rows(metric, 260, 23)
    names = [f"n{i}" for i in range(len(data))]
    a, b = presized_pair(dim, metric)
    r = b.snapshot_refreshes
    for x in (a, b):
        x.add_batch(names[:128], data[:128], batch_size=64)
        x.add_node(names[128], data[128])
    b.device_snapshot()  # wave 2's rows and the add_node's: the host path
    assert (r["full"], r["delta"], r["delta_device"]) == (1, 2, 1)
    assert_snapshot_is_full_rebuild(b)
    for x in (a, b):
        x.add_batch(names[129:200], data[129:200], batch_size=64)
        x.delete_node(names[7])
    b.device_snapshot()  # the last wave's rows after a delete: the device
    # (assert_snapshot_is_full_rebuild's full build counts one more full)
    assert (r["full"], r["delta"], r["delta_device"]) == (2, 4, 3)
    assert_snapshot_is_full_rebuild(b)
    for x in (a, b):
        x.add_batch(names[200:], data[200:], batch_size=64)
    assert_same_graph(a, b)
    assert_snapshot_is_full_rebuild(b)


@pytest.mark.parametrize("backend", ["native", "py"])
@pytest.mark.parametrize("metric", ["euclidean", "hamming"])
def test_wave_delta_after_delete_and_readd(backend, metric):
    """Delete a member of the last wave, then ``add_node`` a new vector:
    the name table hands the freed row straight back, so the dirty rows
    are still exactly the wave's, but that row's vector in the wave's
    block is stale. The delta must upload from the host: the snapshot
    holds the new vector and stays byte-equal to a full rebuild, and a
    scan finds the new node at distance 0. (The JAX package copies the
    stale block here; the graph, built on the host, still equals its.)"""
    dim, data = wave_rows(metric, 200, 29)
    names = [f"n{i}" for i in range(len(data))]
    a, b = presized_pair(dim, metric, native=backend == "native")
    r = b.snapshot_refreshes
    for x in (a, b):
        x.add_batch(names[:192], data[:192], batch_size=64)
    freed = b._names.get(names[150])
    for x in (a, b):
        x.delete_node(names[150])
        x.add_node("readd", data[199])
    assert b._names.get("readd") == freed
    device_before = r["delta_device"]
    snap = b.device_snapshot()
    assert r["delta_device"] == device_before
    assert np.array_equal(
        snap.vecs[freed].numpy().view(b._vectors.dtype), b._vectors[freed])
    assert_snapshot_is_full_rebuild(b)
    assert_same_graph(a, b)
    ids, sims = b.search_batch(data[199:200], 1, engine="scan",
                               reply="columnar")
    assert ids[0, 0] == "readd" and sims[0, 0] == 0
