"""The slice end to end: identical command sequences through
``redis_hnsw_tpu.HNSW`` and ``redis_hnsw_tpu_torch.HNSW(device="cpu")``
give identical replies -- an HNSW index (exact scan tier) and a flat
index with the certificate forced -- and a JAX index carried across by
``convert.index_from_state`` gives the JAX replies and keeps building
the same graph. Integer-lattice data make every distance exact in f32,
so replies are compared exactly, ties included.
"""

import json

import numpy as np
import pytest

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.utils.checkpoint import load_index, save_index


def lattice(n=120, dim=4):
    data = np.zeros((n, dim), np.float32)
    data[:, 0] = np.arange(n) % 16
    data[:, 1] = (np.arange(n) // 16) * 2.0
    data[:, 2] = np.arange(n) % 3
    return data


def norm(reply):
    """Replies as plain data (SearchResult -> (sim, name, data))."""
    if isinstance(reply, tuple):
        return [np.asarray(a).tolist() for a in reply]
    if isinstance(reply, list):
        return [norm(r) for r in reply]
    if hasattr(reply, "info"):  # an index handle (create_index)
        return norm(reply.info())
    if hasattr(reply, "sim"):
        data = None if reply.data is None else reply.data.tolist()
        return (reply.sim, reply.name, data)
    if isinstance(reply, dict):
        return {k: norm(v) for k, v in reply.items()}
    if isinstance(reply, np.ndarray):
        return reply.tolist()
    return reply


def run_both(ops):
    ca, cb = J.HNSW(), T.HNSW(device="cpu")
    for op in ops:
        assert norm(op(ca)) == norm(op(cb))
    return ca, cb


def test_hnsw_command_sequence_identical():
    data = lattice()
    qs = np.concatenate([data[::13] + 0.5, data[5:9]]).astype(np.float32)
    ops = [
        lambda c: c.create_index("g", dim=4, m=4, ef_construction=32,
                                 seed=11),
        *[
            (lambda i: lambda c: c.add_node("g", f"n{i}", data[i]))(i)
            for i in range(120)
        ],
        lambda c: c.get_index("g"),
        lambda c: c.get_node("g", "n42"),
        lambda c: [c.search("g", q, k=5) for q in qs[:4]],
        lambda c: c.search_batch("g", qs, k=7),
        lambda c: c.search_batch("g", qs, k=7, reply="columnar"),
        lambda c: c.search_batch("g", qs, k=7, engine="scan"),
        lambda c: c.search_batch("g", qs, k=7, recall_target=1.0),
        lambda c: c.search_batch("g", qs, k=200),
        *[
            (lambda i: lambda c: c.delete_node("g", f"n{i}"))(i)
            for i in range(0, 120, 11)
        ],
        lambda c: c.delete_batch("g", [f"n{i}" for i in (1, 2, 3, 50)]),
        lambda c: c.search_batch("g", qs, k=7, reply="columnar"),
        lambda c: c.add_node("g", "n0", data[0]),
        lambda c: c.search_batch("g", qs, k=7),
        lambda c: c.get_index("g"),
        lambda c: c.list_indices(),
        lambda c: c.delete_index("g"),
        lambda c: c.list_indices(),
    ]
    run_both(ops)


def test_flat_certified_command_sequence_identical(monkeypatch):
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    data = lattice(300, 4)
    qs = (data[::17] + 0.5).astype(np.float32)
    names = [f"f{i}" for i in range(300)]
    ops = [
        lambda c: c.create_index("fl", dim=4, kind="flat"),
        lambda c: c.add_batch("fl", names[:250], data[:250]),
        *[
            (lambda i: lambda c: c.add_node("fl", names[i], data[i]))(i)
            for i in range(250, 300)
        ],
        lambda c: c.get_index("fl"),
        lambda c: c.search_batch("fl", qs, k=9),
        lambda c: c.search("fl", qs[0], k=4),
        lambda c: c.delete_batch("fl", names[::4]),
        lambda c: c.delete_node("fl", names[1]),
        lambda c: c.search_batch("fl", qs, k=9),
        lambda c: c.get_node("fl", names[2]),
    ]
    from redis_hnsw_tpu_torch.ops import scan as TS

    # an audited batch is no failure: no audit may land on an epoch's first
    monkeypatch.setattr(TS, "CERT_AUDIT_EVERY", 0)
    before = dict(TS.CERT_STATS)
    run_both(ops)
    # the lattice's ties fail each epoch's first certified batch whole, so
    # the port leaves that epoch's later searches to the exact tier
    # (skipped_queries), where the JAX package certifies every batch
    assert TS.CERT_STATS["batches"] >= before["batches"] + 2
    assert TS.CERT_STATS["skipped_queries"] >= before["skipped_queries"] + 1


def _state_of(idx, path):
    save_index(idx, str(path))
    with np.load(str(path), allow_pickle=False) as z:
        state = {key: z[key] for key in z.files}
    state["meta"] = json.loads(bytes(state["meta"].tobytes()).decode())
    return state


@pytest.mark.parametrize("backend", ["py", "auto"])
def test_convert_hnsw_index(tmp_path, backend):
    data = lattice()
    a = J.HNSWIndex("cv", J.IndexConfig(dim=4, m=4, ef_construction=32,
                                        seed=3, backend=backend))
    for i in range(100):
        a.add_node(f"n{i}", data[i])
    a.delete_batch([f"n{i}" for i in range(0, 100, 9)])
    b = T.index_from_state(_state_of(a, tmp_path / "a.npz"), device="cpu")
    a2 = load_index(str(tmp_path / "a.npz"))  # the JAX package's restore
    qs = (data[::7] + 0.25).astype(np.float32)
    for x in (a, a2):
        assert [x._layer_lists(r) for r in range(100)] == [
            b._layer_lists(r) for r in range(100)
        ]
        assert norm(x.search_batch(qs, 6)) == norm(b.search_batch(qs, 6))
        assert norm(x.search_knn(qs[0], 4)) == norm(b.search_knn(qs[0], 4))
        assert x.info() == b.info()
    # both restored indexes resample levels from the same fresh seed
    for i in range(100, 120):
        a2.add_node(f"n{i}", data[i])
        b.add_node(f"n{i}", data[i])
    assert [a2._layer_lists(r) for r in range(120)] == [
        b._layer_lists(r) for r in range(120)
    ]
    assert norm(a2.search_batch(qs, 6)) == norm(b.search_batch(qs, 6))


def test_convert_flat_index(tmp_path):
    data = lattice(200, 4)
    a = J.FlatIndex("cf", J.IndexConfig(dim=4))
    a.add_batch([f"n{i}" for i in range(200)], data)
    a.delete_node("n7")
    b = T.index_from_state(_state_of(a, tmp_path / "f.npz"), device="cpu")
    assert isinstance(b, T.FlatIndex)
    qs = (data[::9] + 0.5).astype(np.float32)
    assert norm(a.search_batch(qs, 5)) == norm(b.search_batch(qs, 5))
    assert np.array_equal(a._vectors[:200], b._vectors[:200])
    assert np.array_equal(a._valid[:200], b._valid[:200])


def test_flat_kernel_path_and_edge_queries():
    """``use_pallas=True`` (kernel A over the whole block) gives the JAX
    package's fused-scan replies; empty query blocks and an empty index
    give its empty replies."""
    data = lattice(300, 4)
    qs = (data[::23] + 0.5).astype(np.float32)
    a = J.FlatIndex("fp", J.IndexConfig(dim=4))
    b = T.FlatIndex("fp", T.IndexConfig(dim=4), device="cpu")
    for x in (a, b):
        assert norm(x.search_batch(qs, 3, reply="columnar")) == norm(
            (np.full((len(qs), 3), None, object),
             np.full((len(qs), 3), -np.inf, np.float32))
        )
        x.add_batch([f"n{i}" for i in range(300)], data)
        x.delete_node("n3")
    assert norm(a.search_batch(qs, 6, use_pallas=True)) == norm(
        b.search_batch(qs, 6, use_pallas=True)
    )
    assert norm(b.search_batch(qs, 6, use_pallas=True)) == norm(
        b.search_batch(qs, 6)
    )
    for reply in ("objects", "columnar"):
        empty = np.zeros((0, 4), np.float32)
        ra = a.search_batch(empty, 5, reply=reply)
        rb = b.search_batch(empty, 5, reply=reply)
        assert norm(ra) == norm(rb)
        if reply == "columnar":
            assert rb[0].shape == rb[1].shape == (0, 5)
