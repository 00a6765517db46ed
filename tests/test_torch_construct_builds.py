"""Bulk builds of the port against the JAX package, on the CPU:
``add_batch`` of the same lattice rows builds the same graph -- every
row's neighbour list at every layer, in order, with levels, enterpoint
and max_layer -- on both host backends, under
``REDIS_HNSW_TPU_BUILD_L0`` = scan and beam, ``REDIS_HNSW_TPU_WAVE_SPLIT``
= 0 and 1, and batch sizes 1, 32 and 128 with a partial trailing wave.
Tolerance: none (integer-lattice rows make every f32 score exact)."""

import numpy as np
import pytest

from test_torch_construct import assert_same_graph, index_pair, lattice


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


