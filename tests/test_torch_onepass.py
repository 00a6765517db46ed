"""The one-pass certified select of the port against the JAX package.

Kernel D's plain version (ops/cuda_select.py ``plain_select_bins``) is
held to ``pallas_select.select_bins_ref`` and to the Pallas kernel in
interpret mode on integer-lattice data, where every score is exact in
f32: the per-bin best scores, their row ids (lowest id on ties, a dead
bin's first row) and m2 must be byte-equal on the first ceil(N/128) bins
(the Pallas kernel pads N to its 16,384-row panel with dead bins). The
one-pass tier (REDIS_HNSW_TPU_CERT_ONEPASS=1 with SCAN_CERT=1; the JAX
package needs the 1, the port takes it by default) must give replies
byte-identical to the port's exact tier and equal to the JAX package's,
fall back on a bin collision, and keep the JAX package's env grammar
(but for auto, which is on here) and its k <= N/128 gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu.ops.scan as JS
import redis_hnsw_tpu_torch as T
import redis_hnsw_tpu_torch.ops.scan as TS
from redis_hnsw_tpu.models.flat import FlatIndex as JFlat
from redis_hnsw_tpu.ops.pallas_select import onepass_enabled as jax_onepass
from redis_hnsw_tpu.ops.pallas_select import select_bins as jax_select
from redis_hnsw_tpu.ops.pallas_select import select_bins_ref
from redis_hnsw_tpu_torch.models.flat import FlatIndex as TFlat
from redis_hnsw_tpu_torch.ops import cuda_scan, cuda_select

BIN_L = cuda_select.BIN_L


def lattice_case(rng, B, N, dim, dead=0.2):
    q = rng.integers(-3, 4, (B, dim)).astype(np.float32)
    x = rng.integers(-3, 4, (N, dim)).astype(np.float32)
    x[100:110] = x[90:100]  # duplicates inside one bin
    x[N - 7] = q[0]  # a distance-0 row
    live = rng.random(N) >= dead
    live[BIN_L : 2 * BIN_L] = False  # bin 1 entirely dead
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    sqm = np.where(live, sq, np.inf).astype(np.float32)
    qq = np.einsum("bd,bd->b", q, q).astype(np.float32)
    return q, x, sqm, qq


def torch_select(q, x, sqm, qq):
    return cuda_select.select_bins(*(torch.from_numpy(a) for a in
                                     (x, sqm, q, qq)))


def bytes_equal(got, want, nb):
    g_s, g_i, g_m = (t.numpy() for t in got)
    w_s, w_i, w_m = (np.asarray(a) for a in want)
    assert g_s.shape[1] == nb
    assert np.array_equal(g_s.view(np.int32), w_s[:, :nb].view(np.int32))
    assert np.array_equal(g_i, w_i[:, :nb])
    assert np.array_equal(g_m.view(np.int32), w_m.view(np.int32))


@pytest.mark.parametrize("N", [2048, 1324, 300])
def test_plain_select_bins_matches_jax(rng, N):
    """Byte-equal to the XLA reference and the Pallas kernel (interpret
    mode), N on and off the 128-row bin and the Pallas panel."""
    q, x, sqm, qq = lattice_case(rng, 16, N, 32)
    got = torch_select(q, x, sqm, qq)
    nb = -(-N // BIN_L)
    args = [jnp.asarray(a) for a in (x, sqm, q, qq)]
    bytes_equal(got, select_bins_ref(*args), nb)
    bytes_equal(got, jax_select(*args, interpret=True), nb)
    sims, ids, _ = got
    assert (sims[:, 1] == float("-inf")).all() and (ids[:, 1] == BIN_L).all()


def test_plain_select_bins_across_chunks(rng, monkeypatch):
    """With a small CHUNK_N the plain version scores in several chunks;
    no bin straddles two, and the result is unchanged."""
    q, x, sqm, qq = lattice_case(rng, 5, 1000, 16)
    want = torch_select(q, x, sqm, qq)
    monkeypatch.setattr(cuda_scan, "CHUNK_N", 2 * BIN_L)
    got = torch_select(q, x, sqm, qq)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_select_bins_best_is_topk_top1(rng):
    """The best candidate of each query is kernel A's top-1 (plain
    versions here, the kernels on the card): same score and id."""
    q, x, sqm, qq = lattice_case(rng, 9, 1500, 24)
    sims, ids, _ = torch_select(q, x, sqm, qq)
    s, pos = torch.sort(sims, dim=1, descending=True, stable=True)
    ti, ts = cuda_scan.flat_topk(*(torch.from_numpy(a) for a in (q, x)),
                                 torch.from_numpy(sqm), torch.from_numpy(qq),
                                 k=1)
    assert torch.equal(ids.gather(1, pos[:, :1]), ti)
    assert torch.equal(s[:, :1].view(torch.int32), ts.view(torch.int32))


@pytest.mark.parametrize(
    "slots,q_tiles,nbins,want",
    [(264, 16, 7813, 33),  # flat-sift1m on 132 SMs x 2: two full waves
     (264, 1, 8, 8),       # one block per bin
     (264, 2, 600, 120),   # one full wave, 5 bins a block
     (264, 16, 300, 16),
     (264, 3000, 5, 1)],   # more query tiles than four waves hold
)
def test_plan_splits(slots, q_tiles, nbins, want):
    """Kernel D's row splits: the fewest that minimise waves x bins per
    split over the card's resident block slots."""
    got = cuda_select.plan_splits(slots, q_tiles, nbins)
    assert got == want
    waves = -(-q_tiles * got // slots)
    assert got <= nbins and (got == 1 or waves <= 4)


# -- the one-pass tier --------------------------------------------------------------

@pytest.fixture
def onepass(monkeypatch):
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "1")
    JS.scan_certified_l2.clear_cache()
    yield monkeypatch
    JS.scan_certified_l2.clear_cache()


def flat_pair(data):
    names = [f"n{i}" for i in range(len(data))]
    a = JFlat("f", J.IndexConfig(dim=data.shape[1]))
    b = TFlat("f", T.IndexConfig(dim=data.shape[1]), device="cpu")
    a.add_batch(names, data)
    b.add_batch(names, data)
    return a, b


def exact_reply(b, qs, k, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setenv("REDIS_HNSW_TPU_SCAN_CERT", "0")
        return b.search_batch(qs, k, reply="columnar")


def same(ra, rb):
    assert np.array_equal(ra[0], rb[0])
    assert np.array_equal(ra[1].view(np.int32), rb[1].view(np.int32))


def same_as_jax(ja, rb):
    """Names equal; sims to 1e-5 relative: on Gaussian data the port's
    direct-form rescore sums in its own fixed order (ops/distance.py
    _sum_last), so a sim may differ from the JAX package's in the last
    ulp (ROADMAP queue 3)."""
    assert np.array_equal(ja[0], rb[0])
    np.testing.assert_allclose(ja[1], rb[1], rtol=1e-5)


def test_onepass_matches_exact_and_jax(rng, onepass):
    """Each query's true top-k planted in distinct bins: every query
    certifies with no fallback; replies equal the exact tier's byte for
    byte and the JAX package's one-pass replies; deletes stay masked."""
    n, dim, k, n_q = 2600, 24, 10, 8
    data = (10 * rng.standard_normal((n, dim))).astype(np.float32)
    qs = (10 * rng.standard_normal((n_q, dim))).astype(np.float32)
    for i in range(n_q):
        for j in range(k):
            data[j * 2 * BIN_L + i] = qs[i] + 0.01 * rng.standard_normal(dim)
    a, b = flat_pair(data)
    want = exact_reply(b, qs, k, onepass)
    before = dict(TS.CERT_STATS)
    launches = cuda_select.select_bins.launches
    got = b.search_batch(qs, k, reply="columnar")
    assert TS.CERT_STATS["batches"] == before["batches"] + 1
    assert TS.CERT_STATS["fallback_queries"] == before["fallback_queries"]
    assert cuda_select.select_bins.launches == launches  # CPU: plain
    same(got, want)
    same_as_jax(a.search_batch(qs, k, reply="columnar"), got)
    a.delete_node("n0")
    b.delete_node("n0")  # a planted top-1 of query 0
    got = b.search_batch(qs, k, reply="columnar")
    same(got, exact_reply(b, qs, k, onepass))
    assert "n0" not in got[0][0]
    same_as_jax(a.search_batch(qs, k, reply="columnar"), got)


def test_onepass_bin_collision_falls_back(rng, onepass):
    """Eight consecutive copies of every row share a bin: m2 reaches t,
    no query certifies, and the exact fallback serves every query."""
    data = np.repeat((10 * rng.standard_normal((60, 24))).astype(np.float32),
                     8, axis=0)
    qs = (10 * rng.standard_normal((16, 24))).astype(np.float32)
    a, b = flat_pair(data)
    want = exact_reply(b, qs, 10, onepass)
    before = TS.CERT_STATS["fallback_queries"]
    got = b.search_batch(qs, 10, reply="columnar")
    assert TS.CERT_STATS["fallback_queries"] >= before + 16
    same(got, want)
    jgot = a.search_batch(qs, 10)
    assert [[r.name for r in row] for row in jgot] == got[0].tolist()


def test_onepass_k_above_bins_takes_two_pass(rng, onepass):
    """k > N/128 fails the JAX package's gate: the two-pass form serves
    (kernel D is not called), on both packages, with equal replies."""
    data = rng.integers(-3, 4, (300, 16)).astype(np.float32)
    qs = rng.integers(-3, 4, (6, 16)).astype(np.float32)
    a, b = flat_pair(data)  # 384 padded rows: 3 bins

    def refuse(*args):
        raise AssertionError("kernel D called above the k <= N/128 gate")

    want = exact_reply(b, qs, 4, onepass)
    onepass.setattr(TS, "select_bins", refuse)
    got = b.search_batch(qs, 4, reply="columnar")
    same(got, want)
    same(a.search_batch(qs, 4, reply="columnar"), got)
    assert TS.onepass_enabled()


def test_onepass_env_grammar(monkeypatch):
    """0 and 1 as in the JAX package; auto, the default, is on in the
    port (measured faster than the two-pass form, PERF.md) where the JAX
    package leaves it off."""
    for v, want in (("0", False), ("1", True)):
        monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", v)
        assert TS.onepass_enabled() is want is jax_onepass()
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "auto")
    assert TS.onepass_enabled() is True and jax_onepass() is False
    monkeypatch.delenv("REDIS_HNSW_TPU_CERT_ONEPASS")
    assert TS.onepass_enabled() is True
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "junk")
    for fn in (TS.onepass_enabled, jax_onepass):
        with pytest.raises(ValueError, match="CERT_ONEPASS"):
            fn()


def test_onepass_is_the_default(rng, monkeypatch):
    """With REDIS_HNSW_TPU_CERT_ONEPASS unset the certified tier selects
    with kernel D (plain version here) and never counts with kernel B;
    with 0 it takes the two-pass form. Both give the exact tier's reply.
    The lattice's ties fail the first call's certificate, so every batch
    is made a probe (CERT_PROBE_EVERY = 1): the table's fallback history
    would send the second call straight to the exact tier."""
    data = rng.integers(-3, 4, (1300, 16)).astype(np.float32)
    qs = rng.integers(-3, 4, (9, 16)).astype(np.float32)
    _, b = flat_pair(data)  # 1408 padded rows: 11 bins
    want = exact_reply(b, qs, 5, monkeypatch)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.delenv("REDIS_HNSW_TPU_CERT_ONEPASS", raising=False)
    monkeypatch.setattr(TS, "CERT_PROBE_EVERY", 1)
    calls = []
    for name in ("select_bins", "count_gt_eq"):
        real = getattr(TS, name)
        monkeypatch.setattr(
            TS, name,
            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    same(b.search_batch(qs, 5, reply="columnar"), want)
    assert calls == ["select_bins"]
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "0")
    same(b.search_batch(qs, 5, reply="columnar"), want)
    assert calls == ["select_bins", "count_gt_eq"]
