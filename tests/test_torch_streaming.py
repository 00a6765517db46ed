"""The streaming 50/50 insert+query mix (BASELINE.json config 4) of the
port against the JAX package's, on the CPU.

``run_mixed`` over the same lattice rows and queries builds the same
graph in both packages -- every neighbour list, levels, enterpoint --
and serves the same number of queries, serially and in overlap mode;
and a search with ``staleness`` serves the pre-wave view byte for byte
(``tests/test_streaming.py::test_staleness_serves_pre_wave_view``).
Small lattice streams (a few hundred rows) keep these unmarked.
"""

import numpy as np
import pytest

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.utils.streaming import run_mixed as j_run_mixed
from redis_hnsw_tpu_torch.utils.streaming import run_mixed as t_run_mixed
from test_torch_construct import assert_same_graph


def lattice(n, dim, seed):
    return np.random.default_rng(seed).integers(-4, 5, (n, dim)).astype(
        np.float32)


def pair(name, backend="native", **kw):
    cfg = dict(dim=16, m=6, ef_construction=48, seed=4, **kw)
    a = J.HNSWIndex(name, J.IndexConfig(backend=backend, **cfg))
    b = T.HNSWIndex(name, T.IndexConfig(backend=backend, **cfg),
                    device="cpu")
    return a, b


def norm(res):
    return [[(r.name, r.sim) for r in rr] for rr in res]


@pytest.mark.parametrize("backend,overlap,slices", [
    ("native", False, 1), ("py", False, 1), ("native", True, 2),
    ("py", True, 1)])
def test_mixed_stream_matches_jax(backend, overlap, slices):
    n, k = 330, 5
    data = lattice(n, 16, 1)
    queries = lattice(64, 16, 2)
    names = [f"n{i}" for i in range(n)]
    a, b = pair("s", backend)
    kw = dict(k=k, insert_wave=64, query_batch=32, expand=4,
              validate_every=2, overlap=overlap, slices=slices)
    sa = j_run_mixed(a, names, data, queries, **kw)
    sb = t_run_mixed(b, names, data, queries, **kw)
    assert (sb.inserts, sb.queries) == (sa.inserts, sa.queries) == (
        n, (n // 32) * 32 if overlap else 6 * 32)
    assert len(sb.insert_ms) == len(sa.insert_ms)
    assert len(sb.query_ms) == len(sa.query_ms)
    assert b.node_count == n
    assert_same_graph(a, b)
    qs = queries[:16]
    for engine in ("scan", "graph"):
        assert norm(b.search_batch(qs, k, engine=engine, ef_search=48,
                                   expand=4)) == norm(
            a.search_batch(qs, k, engine=engine, ef_search=48, expand=4))
    # the wall decomposition covers the elapsed time (unrounded fields)
    total = (sb.insert_total_s + sb.query_total_s + sb.validate_total_s
             + sb.other_total_s)
    assert abs(total - sb.elapsed_s) < 1e-6
    s = sb.summary()
    assert s["query_p95_ms"] >= s["query_p50_ms"]


def test_stream_validates_self_hits():
    """The validate probe fails the stream when a wave's rows are not
    served back: here by serving from a view that never sees them."""
    data = lattice(200, 16, 3)
    names = [f"n{i}" for i in range(200)]
    _, b = pair("v")
    b.search_batch = (lambda orig: lambda qs, k, **kw: orig(
        qs, k, **{**kw, "staleness": 10**6}))(b.search_batch)
    b.add_batch(names[:100], data[:100], batch_size=50)
    b.search_batch(data[:4], 1)  # materialize the view, then freeze it
    with pytest.raises(AssertionError, match="stream visibility"):
        t_run_mixed(b, names[100:], data[100:], data[:32], k=1,
                    insert_wave=50, query_batch=32, validate_every=1)


def test_staleness_serves_pre_wave_view():
    """search_batch(staleness=N) serves the bounded-stale device view:
    rows inserted after the materialized snapshot are invisible and no
    dirty-row delta runs; a fresh search afterwards sees them. The stale
    reply equals a fresh search on a twin frozen at the pre-wave state,
    and the JAX package's stale reply."""
    n0, nw, k = 300, 64, 5
    data = lattice(n0 + nw, 16, 5)
    queries = lattice(16, 16, 6)
    names = [f"n{i}" for i in range(n0 + nw)]
    a, b = pair("st")
    ta, tb = pair("tw")
    for x in (a, b, ta, tb):
        x._capacity_hint = n0 + nw
        x.add_batch(names[:n0], data[:n0], batch_size=64)
    for x in (a, b):
        x.search_batch(queries, k)  # materialize snapshot + scan state
        x.add_batch(names[n0:], data[n0:], batch_size=nw)
    epoch_before = b._snapshot_epoch
    for eng in ("scan", "graph"):
        kw = dict(engine=eng, ef_search=48, expand=4)
        stale = norm(b.search_batch(queries, k, staleness=10 * nw, **kw))
        assert stale == norm(tb.search_batch(queries, k, **kw)), eng
        assert stale == norm(a.search_batch(queries, k, staleness=10 * nw,
                                            **kw)), eng
        assert b._snapshot_epoch == epoch_before, eng
        assert not {nm for rr in stale for nm, _ in rr} & set(names[n0:])
    fresh = norm(b.search_batch(queries, 2 * k, engine="scan"))
    assert b._snapshot_epoch != epoch_before
    assert fresh == norm(a.search_batch(queries, 2 * k, engine="scan"))
    assert {nm for rr in fresh for nm, _ in rr} & set(names[n0:])


def test_device_query_batches_upload_once():
    from redis_hnsw_tpu_torch.utils.streaming import _device_query_batches

    pool = lattice(64, 16, 7)
    parts = _device_query_batches(pool, 32, "cpu")
    assert len(parts) == 2 and parts[0].data_ptr() + 32 * 16 * 4 == (
        parts[1].data_ptr())
    np.testing.assert_array_equal(parts[1].numpy(), pool[32:])
    assert _device_query_batches(pool, 48, "cpu") is None
    assert _device_query_batches(pool.view(np.uint32), 32, "cpu") is None
