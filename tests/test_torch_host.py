"""Host half of the torch port against the JAX package.

The graph mutation path (insert, delete, batch delete, single-query
search) is carried over unchanged in semantics, with numpy's
``default_rng(seed)`` level sampler, so on integer-lattice data (every
distance exact in f32) the same command sequence must build BYTE-EQUAL
adjacency in both packages, on both host backends, and give identical
search_knn / info / get_node replies and error strings. Pattern of
tests/test_native.py::test_sequential_build_identical_graphs and
::test_delete_repair_identical.
"""

import shutil

import numpy as np
import pytest

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu import native_core as jax_native
from redis_hnsw_tpu_torch import native_core as torch_native
from tests.test_core import graph_invariants

N = 120
VICTIMS = sorted(set(range(0, N, 7)) | set(range(1, 40, 3)))


def lattice(n=N, dim=4):
    data = np.zeros((n, dim), np.float32)
    data[:, 0] = np.arange(n) % 16
    data[:, 1] = (np.arange(n) // 16) * 2.0
    data[:, 2] = np.arange(n) % 3
    return data


def build_pair(backend, n=N, seed=11, m=4, efcon=32):
    if backend == "native" and (
        jax_native.load() is None or torch_native.load() is None
    ):
        pytest.skip("native core unavailable")
    data = lattice(n)
    a = J.HNSWIndex(
        "ix", J.IndexConfig(dim=4, m=m, ef_construction=efcon, seed=seed,
                            backend=backend),
    )
    b = T.HNSWIndex(
        "ix", T.IndexConfig(dim=4, m=m, ef_construction=efcon, seed=seed,
                            backend=backend),
        device="cpu",
    )
    for i in range(n):
        a.add_node(f"n{i}", data[i])
        b.add_node(f"n{i}", data[i])
    return a, b, data


def test_both_host_cores_load():
    """Both packages' native host cores build and load wherever g++ and
    make exist, so a lost build (two test workers racing one ``make``, or
    one running out of time) fails here rather than skipping the native
    tests quietly."""
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("needs g++ and make")
    assert jax_native.load() is not None
    assert torch_native.load() is not None


def adjacency_of(idx, n=N):
    return [idx._layer_lists(r) for r in range(n)]


def same_state(a, b):
    assert a.max_layer == b.max_layer
    assert a.enterpoint == b.enterpoint
    assert a.node_count == b.node_count
    assert np.array_equal(a._levels, b._levels)
    assert np.array_equal(a._vectors, b._vectors)
    assert adjacency_of(a) == adjacency_of(b)


@pytest.mark.parametrize("backend", ["py", "native"])
def test_build_and_deletes_identical_graphs(backend):
    a, b, _ = build_pair(backend)
    assert (b._native is not None) == (backend == "native")
    same_state(a, b)
    for i in VICTIMS[:10]:
        a.delete_node(f"n{i}")
        b.delete_node(f"n{i}")
    same_state(a, b)
    rest = [f"n{i}" for i in VICTIMS[10:]]
    a.delete_batch(rest)
    b.delete_batch(rest)
    same_state(a, b)
    graph_invariants(b)
    # re-adds reuse freed rows in the same order
    for i in VICTIMS[:5]:
        a.add_node(f"n{i}", lattice()[i])
        b.add_node(f"n{i}", lattice()[i])
    same_state(a, b)


@pytest.mark.parametrize("backend", ["py", "native"])
def test_search_knn_info_get_node_identical(backend):
    a, b, data = build_pair(backend)
    for q in (data[17], data[3] + 0.5, np.zeros(4, np.float32)):
        for ef in (None, 8):
            ra = a.search_knn(q, 5, ef_search=ef)
            rb = b.search_knn(q, 5, ef_search=ef)
            assert [(r.name, r.sim) for r in ra] == [
                (r.name, r.sim) for r in rb
            ]
            assert all(
                np.array_equal(x.data, y.data) for x, y in zip(ra, rb)
            )
    assert a.info() == b.info()
    for name in ("n0", "n57", "n119"):
        ga, gb = a.get_node(name), b.get_node(name)
        assert np.array_equal(ga["data"], gb["data"])
        assert ga["neighbors"] == gb["neighbors"]
    assert sorted(a.node_names()) == sorted(b.node_names())


def _err(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_error_strings_identical():
    ca, cb = J.HNSW(), T.HNSW(device="cpu")
    for c in (ca, cb):
        c.create_index("e", dim=4, seed=1)
        c.add_node("e", "x", np.zeros(4, np.float32))
    cases = [
        lambda c: c.create_index("e", dim=4),
        lambda c: c.get_index("nope"),
        lambda c: c.delete_index("nope"),
        lambda c: c.add_node("e", "x", np.zeros(4, np.float32)),
        lambda c: c.add_node("e", "y", np.zeros(5, np.float32)),
        lambda c: c.add_node("e", "", np.zeros(4, np.float32)),
        lambda c: c.get_node("e", "nope"),
        lambda c: c.delete_node("e", "nope"),
        lambda c: c.delete_batch("e", ["x", "x"]),
        lambda c: c.search("e", np.zeros(3, np.float32)),
        lambda c: c.search_batch("e", np.zeros((2, 3), np.float32)),
        lambda c: c.search_batch("e", np.zeros((2, 4), np.float32),
                                 engine="bogus"),
        lambda c: c.search_batch("e", np.zeros((2, 4), np.float32),
                                 reply="bogus"),
        lambda c: c.create_index("z", dim=4, kind="bogus"),
        lambda c: c.create_index("z", dim=0),
        lambda c: c.create_index("z", dim=4, m=1),
        lambda c: c.create_index("z", dim=4, ef_construction=0),
        lambda c: c.create_index("z", dim=4, metric="cosine"),
        lambda c: c.create_index("z", dim=33, metric="hamming"),
        lambda c: c.create_index("z", dim=4, backend="gpu"),
    ]
    for case in cases:
        assert _err(lambda: case(ca)) == _err(lambda: case(cb))
    # fixed capacity
    for c in (ca, cb):
        c.create_index("cap", dim=4, capacity=8, fixed_capacity=True)
        for i in range(8):
            c.add_node("cap", f"c{i}", np.full(4, i, np.float32))
    assert _err(
        lambda: ca.add_node("cap", "c9", np.zeros(4, np.float32))
    ) == _err(lambda: cb.add_node("cap", "c9", np.zeros(4, np.float32)))
    assert ca.list_indices() == cb.list_indices()
