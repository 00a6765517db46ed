"""ops/distance.py and ops/snapshot.py of the torch port against the JAX
package, function by function, on the same numpy inputs.

Tolerance: integer-lattice inputs make every value exact in f32, so the
two packages must agree byte for byte; on Gaussian inputs XLA's CPU dot
and torch.mm (and the two sum orders) round differently, so values agree
to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.ops import distance as JD
from redis_hnsw_tpu_torch.ops import distance as TD


def lattice(rng, *shape):
    return rng.integers(-6, 7, shape).astype(np.float32)


def gauss(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_host_functions_identical(rng):
    q, xs = gauss(rng, 16), gauss(rng, 40, 16)
    assert np.array_equal(JD.neg_sq_l2_np(q, xs), TD.neg_sq_l2_np(q, xs))
    qb = rng.integers(0, 2**32, 4, dtype=np.uint32)
    xb = rng.integers(0, 2**32, (40, 4), dtype=np.uint32)
    assert np.array_equal(JD.hamming_np(qb, xb), TD.hamming_np(qb, xb))
    for metric, a, b in (("euclidean", q, xs), ("hamming", qb, xb)):
        assert np.array_equal(
            JD.sim_np(a, b, metric), TD.sim_np(a, b, metric)
        )


@pytest.mark.parametrize("make", [lattice, gauss])
def test_device_functions_match(rng, make):
    exact = make is lattice
    q, x = make(rng, 12, 24), make(rng, 300, 24)
    ids = rng.integers(0, 300, (12, 7)).astype(np.int32)
    mask = rng.random((12, 7)) > 0.2
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)

    def same(got, want):
        got, want = np.asarray(got), np.asarray(want)
        if exact:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    same(TD.sqnorms(xt), JD.sqnorms(jnp.asarray(x)))
    same(
        TD.pairwise_neg_sq_l2(qt, xt),
        JD.pairwise_neg_sq_l2(jnp.asarray(q), jnp.asarray(x)),
    )
    same(
        TD.exact_neg_sq_l2(qt, xt, torch.from_numpy(ids).long(),
                           torch.from_numpy(mask)),
        JD.exact_neg_sq_l2(jnp.asarray(q), jnp.asarray(x),
                           jnp.asarray(ids), jnp.asarray(mask)),
    )


def test_resort_desc_ties_match(rng):
    # adversarial ties: few distinct sims, shuffled ids, -inf slots
    sims = rng.integers(-3, 1, (20, 16)).astype(np.float32)
    sims[sims == 0] = -np.inf
    ids = np.stack([rng.permutation(50)[:16] for _ in range(20)]).astype(
        np.int32
    )
    ti, ts = TD.resort_desc(torch.from_numpy(ids), torch.from_numpy(sims))
    ji, js = JD.resort_desc(jnp.asarray(ids), jnp.asarray(sims))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def _snap_tables(s):
    return {
        "vecs": np.asarray(s.vecs),
        "sqnorms": np.asarray(s.sqnorms),
        "adj0": np.asarray(s.adj0),
        "adj_up": np.asarray(s.adj_up),
        "upper_of": np.asarray(s.upper_of),
        "ep": int(s.ep),
        "max_layer": int(s.max_layer),
        "n_pad": s.n_pad,
        "live_hw": s.live_hw,
    }


def assert_same_snapshot(sj, st):
    a, b = _snap_tables(sj), _snap_tables(st)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("backend", ["py", "auto"])
def test_snapshot_tables_full_and_delta(rng, backend):
    """Full rebuild, then a dirty-row delta (adds, deletes, a batch
    delete), then a rebuild on growth: the torch snapshot's tables are
    byte-equal to the JAX snapshot's after each, and the delta is
    applied in place (the tensors are the previous snapshot's)."""
    data = lattice(rng, 400, 8)
    a = J.HNSWIndex("s", J.IndexConfig(dim=8, m=4, ef_construction=24,
                                       seed=3, backend=backend))
    b = T.HNSWIndex("s", T.IndexConfig(dim=8, m=4, ef_construction=24,
                                       seed=3, backend=backend),
                    device="cpu")

    def both(fn):
        fn(a)
        fn(b)

    for i in range(100):
        both(lambda ix: ix.add_node(f"n{i}", data[i]))
    assert_same_snapshot(a.device_snapshot(), b.device_snapshot())
    prev_vecs = b.device_snapshot().vecs
    for i in range(100, 120):
        both(lambda ix: ix.add_node(f"n{i}", data[i]))
    for i in (3, 50, 77):
        both(lambda ix: ix.delete_node(f"n{i}"))
    both(lambda ix: ix.delete_batch(["n10", "n11", "n90"]))
    sb = b.device_snapshot()
    assert sb.vecs is prev_vecs  # delta: rows copied in place
    assert_same_snapshot(a.device_snapshot(), sb)
    for i in range(120, 300):  # past 128 rows: n_pad doubles, rebuild
        both(lambda ix: ix.add_node(f"n{i}", data[i]))
    sb = b.device_snapshot()
    assert sb.vecs is not prev_vecs and sb.n_pad == 512
    assert_same_snapshot(a.device_snapshot(), sb)


def test_bounded_staleness_contract(rng):
    """device_snapshot(max_staleness): a snapshot at most that many
    epochs behind is served as is; rows allocated after it are
    invisible to the scan (live_hw); a larger lag refreshes."""
    from redis_hnsw_tpu_torch.ops.scan import _scan_state

    data = gauss(rng, 40, 8)
    b = T.HNSWIndex("st", T.IndexConfig(dim=8, m=4, seed=1),
                    device="cpu")
    for i in range(30):
        b.add_node(f"n{i}", data[i])
    s0 = b.device_snapshot()
    b.add_node("n30", data[30])
    b.add_node("n31", data[31])
    assert b.device_snapshot(max_staleness=2) is s0
    _, _, _, live, _ = _scan_state(b, max_staleness=2)
    assert int(live.sum()) == 30 and s0.live_hw == 30
    got = b.search_batch(data[31:32], 1, staleness=2)
    assert got[0][0].name != "n31"
    s1 = b.device_snapshot(max_staleness=1)  # lag 2 > 1: refresh
    assert s1.live_hw == 32
    assert b.search_batch(data[31:32], 1)[0][0].name == "n31"
