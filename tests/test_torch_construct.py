"""Bulk wave construction of the port against the JAX package, on the CPU.

The same seeded inputs go through ``redis_hnsw_tpu.ops.construct`` and
``redis_hnsw_tpu_torch.ops.construct``:

* the upper-layer beam (``beam_search`` under ``row_map=upper_of`` with a
  partial ``active`` mask), ``construct_scores`` (split and unsplit) and
  ``construct_upper_scores`` on byte-equal snapshots give equal packed
  buffers: equal ids and bitwise-equal sims in every block, inactive
  lanes and layers included; ``unpack_scores`` inverts the packing;
* ``add_batch`` on random hamming bits builds the JAX package's graph
  (the euclidean lattice builds are in test_torch_construct_builds.py);
* the snapshot refreshed by deltas through a build is byte-equal to a
  full rebuild of the same index.

Tolerance: none. Integer-lattice rows make every f32 score exact and
hamming scores are integers, so every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.ops import construct as JC
from redis_hnsw_tpu.ops import search as JS
from redis_hnsw_tpu_torch.ops import construct as TC
from redis_hnsw_tpu_torch.ops import search as TS
from redis_hnsw_tpu_torch.ops.snapshot import build_snapshot

M, EFCON, SEED = 6, 48, 5


def lattice(rng, n, dim):
    return rng.integers(-4, 5, (n, dim)).astype(np.float32)


def index_pair(dim, metric="euclidean", native=True, m=M, efcon=EFCON):
    kw = dict(dim=dim, m=m, ef_construction=efcon, seed=SEED, metric=metric)
    a = J.HNSWIndex("c", J.IndexConfig(**kw))
    b = T.HNSWIndex("c", T.IndexConfig(**kw), device="cpu")
    if not native:
        a._native = b._native = None
    return a, b


def same_bits(ja, tt):
    arr = np.asarray(ja)
    got = tt.numpy()
    return arr.shape == got.shape and arr.tobytes() == got.tobytes()


def assert_same_graph(a, b):
    """Every row's neighbour list at every layer, in order, plus levels,
    enterpoint and max_layer."""
    hw = a._names.high_water
    assert hw == b._names.high_water
    assert a.max_layer == b.max_layer
    assert a.enterpoint == b.enterpoint
    assert np.array_equal(a._levels[:hw], b._levels[:hw])
    for row in range(hw):
        for lc in range(int(a._levels[row]) + 1):
            assert a._nbrs(row, lc) == b._nbrs(row, lc), (row, lc)


@pytest.fixture(scope="module")
def pair():
    """One add_node-built lattice index on each side (300 x 16), their
    snapshots, and a wave of 37 lattice queries with sampled levels."""
    rng = np.random.default_rng(21)
    data = lattice(rng, 300, 16)
    a, b = index_pair(16)
    for i, row in enumerate(data):
        a.add_node(f"n{i}", row)
        b.add_node(f"n{i}", row)
    sa, sb = a.device_snapshot(), b.device_snapshot()
    assert sb.max_layer >= 2
    qs = TC._pad_lanes(lattice(rng, 37, 16))
    levels = np.minimum(rng.geometric(0.55, len(qs)) - 1, sb.max_layer + 1)
    levels[37:] = 0
    return sa, sb, qs, levels.astype(np.int32)


def up_sel_of(levels, w_pad):
    """dispatch_wave's compact upper-lane list, pow2-padded by repeating
    its first entry."""
    lanes = np.nonzero(levels >= 1)[0].astype(np.int32)
    sel = np.full(max(8, 1 << int(np.ceil(np.log2(max(len(lanes), 1))))),
                  lanes[0], np.int32)
    sel[: len(lanes)] = lanes
    assert len(sel) <= w_pad
    return sel


@pytest.mark.parametrize("expand", [1, 16])
def test_upper_beam_row_map_active_equal(pair, expand):
    """beam_search over an upper layer (row_map=upper_of) with a partial
    active mask: inactive lanes come back as their entry point, and
    every lane's ids and sims equal the JAX package's."""
    sa, sb, qs, _ = pair
    tq = torch.from_numpy(qs)
    tqn = TS._query_sqnorms("euclidean", tq)
    jq, jqn = jnp.asarray(qs), JS._query_sqnorms("euclidean", jnp.asarray(qs))
    active = np.arange(len(qs)) % 3 != 1
    for lc in range(1, sb.max_layer + 1):
        # entry points: upper-layer rows, as a descent leaves them
        ups = np.flatnonzero(sb.upper_of.numpy() >= 0)
        ep = ups[np.arange(len(qs)) % len(ups)].astype(np.int32)
        sims = TS._point_sims("euclidean", tq, tqn, sb.vecs, sb.sqnorms,
                              torch.from_numpy(ep))
        ji, js = JS.beam_search(
            "euclidean", jq, jqn, sa.vecs, sa.sqnorms, sa.adj_up[lc - 1],
            jnp.asarray(ep), jnp.asarray(sims.numpy()), 40,
            row_map=sa.upper_of, active=jnp.asarray(active), expand=expand,
            iters=11)
        ti, ts = TS.beam_search(
            "euclidean", tq, tqn, sb.vecs, sb.sqnorms, sb.adj_up[lc - 1],
            torch.from_numpy(ep), sims, 40, row_map=sb.upper_of,
            active=torch.from_numpy(active), expand=expand, iters=11)
        assert same_bits(ji, ti) and same_bits(js, ts), lc
        assert (ti.numpy()[~active, 0] == ep[~active]).all()
        assert (ti.numpy()[~active, 1:] == -1).all()


@pytest.mark.parametrize("split", [False, True])
def test_construct_scores_equal(pair, split):
    """construct_scores on byte-equal snapshots: the packed buffers are
    equal word for word, so every unpacked block is (ids equal, sims
    bitwise), including layers above max_layer and inactive lanes."""
    sa, sb, qs, levels = pair
    w_pad = len(qs)
    sel = up_sel_of(levels, w_pad) if split else None
    fetch_l = 4 if sb.adj_up.shape[0] >= 4 else sb.adj_up.shape[0]
    kw = dict(ef=EFCON, metric="euclidean", expand=TC.BUILD_EXPAND,
              fetch_c=32, fetch_l=fetch_l)
    jflat, jcross = JC.construct_scores(
        sa.vecs, sa.sqnorms, sa.adj0, sa.adj_up, sa.upper_of, sa.ep,
        sa.max_layer, jnp.asarray(qs), jnp.asarray(levels), sa.nbrvec,
        sa.nbrsqn, sa.qrows, None if sel is None else jnp.asarray(sel), **kw)
    tflat, tcross = TC.construct_scores(
        sb.vecs, sb.sqnorms, sb.adj0, sb.adj_up, sb.upper_of, sb.ep,
        sb.max_layer, torch.from_numpy(qs), torch.from_numpy(levels),
        sb.nbrvec, sb.nbrsqn, sb.qrows,
        None if sel is None else torch.from_numpy(sel), **kw)
    assert jcross is None and tcross is None
    assert same_bits(jflat, tflat)
    w_up = None if sel is None else len(sel)
    up_ids, up_sims, l0_ids, l0_sims = TC.unpack_scores(
        tflat.numpy(), fetch_l, w_pad, 32, w_up)
    assert np.isfinite(l0_sims[:, 0]).all()
    # round trip: packing the unpacked blocks gives the buffer back
    repacked = TC._pack(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in (up_ids, up_sims, l0_ids, l0_sims)))
    assert torch.equal(repacked, tflat)


def test_construct_upper_scores_equal(pair):
    sa, sb, qs, levels = pair
    sel = up_sel_of(levels, len(qs))
    kw = dict(ef=EFCON, metric="euclidean", expand=TC.BUILD_EXPAND,
              fetch_c=32, fetch_l=2)
    jflat = JC.construct_upper_scores(
        sa.vecs, sa.sqnorms, sa.adj_up, sa.upper_of, sa.ep, sa.max_layer,
        jnp.asarray(qs), jnp.asarray(levels), jnp.asarray(sel), **kw)
    tflat = TC.construct_upper_scores(
        sb.vecs, sb.sqnorms, sb.adj_up, sb.upper_of, sb.ep, sb.max_layer,
        torch.from_numpy(qs), torch.from_numpy(levels),
        torch.from_numpy(sel), **kw)
    assert same_bits(jflat, tflat)
    assert tflat.numel() == 2 * 2 * len(sel) * 32


def test_unpack_scores_round_trip():
    rng = np.random.default_rng(3)
    l_pad, w_pad, w_up, c = 3, 16, 8, 5
    blocks = (rng.integers(-1, 99, (l_pad, w_up, c), dtype=np.int32),
              rng.standard_normal((l_pad, w_up, c)).astype(np.float32),
              rng.integers(-1, 99, (w_pad, c), dtype=np.int32),
              rng.standard_normal((w_pad, c)).astype(np.float32))
    flat = TC._pack(*(torch.from_numpy(x) for x in blocks)).numpy()
    assert flat.dtype == np.int32
    for want, got in zip(blocks, TC.unpack_scores(flat, l_pad, w_pad, c,
                                                  w_up)):
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


# -- whole builds ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "py"])
def test_hamming_bulk_build_graph_identical(backend):
    """Random 96-bit rows, beam path with the cross sims on the device:
    the same graph as the JAX package's, the same -popcount cross."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2**32, (200, 3), dtype=np.uint32)
    data[150:155] = data[4]  # a tie class
    names = [f"h{i}" for i in range(200)]
    a, b = index_pair(96, metric="hamming", native=backend == "native",
                      m=5, efcon=32)
    a.add_batch(names, data, batch_size=64)
    b.add_batch(names, data, batch_size=64)
    assert_same_graph(a, b)
    snap = b.device_snapshot()
    assert not TC._build_l0_scan(b, snap, 32)


def test_delta_snapshot_equals_full_rebuild(rng):
    """A presized build refreshes its snapshot by deltas after the first
    wave; the result is byte-equal to a full rebuild of the same index."""
    data = rng.standard_normal((600, 16)).astype(np.float32)
    b = T.HNSWIndex("d", T.IndexConfig(dim=16, m=8, ef_construction=40,
                                       seed=2), device="cpu")
    b.add_batch([f"n{i}" for i in range(600)], data, batch_size=128)
    snap = b.device_snapshot()
    assert b.snapshot_refreshes["full"] == 1
    assert b.snapshot_refreshes["delta"] == 5  # waves 2-5, then this one
    full = build_snapshot(b)
    for field in ("vecs", "sqnorms", "adj0", "adj_up", "upper_of",
                  "nbrvec", "nbrsqn"):
        got, want = getattr(snap, field), getattr(full, field)
        assert got.dtype == want.dtype and torch.equal(got, want), field
    assert (snap.ep, snap.max_layer, snap.n_pad) == (
        full.ep, full.max_layer, full.n_pad)
