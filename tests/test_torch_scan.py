"""The scan engine of the torch port (ops/scan.py) against the JAX
package's: the exact tier, the certified-exact tier with its tie
fallback, the audit and the coalesced rerun sink, and the cert gates.

Lattice data (exact in f32) must give byte-identical replies in both
packages; the certified tier must give byte-identical replies to the
port's own exact tier on any data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu.ops.scan as JS
import redis_hnsw_tpu_torch.ops.scan as TS
import redis_hnsw_tpu_torch.ops.search as TSearch
from redis_hnsw_tpu import IndexConfig as JConfig
from redis_hnsw_tpu.models.flat import FlatIndex as JFlat
from redis_hnsw_tpu_torch import IndexConfig as TConfig
from redis_hnsw_tpu_torch.models.flat import FlatIndex as TFlat


def pair(data, dim):
    names = [f"n{i}" for i in range(len(data))]
    a = JFlat("f", JConfig(dim=dim))
    b = TFlat("f", TConfig(dim=dim), device="cpu")
    a.add_batch(names, data)
    b.add_batch(names, data)
    return a, b


def replies(res):
    return [[(r.sim, r.name) for r in row] for row in res]


@pytest.mark.parametrize("lattice", [True, False])
def test_exact_tier_matches_jax(rng, lattice):
    n, dim, B, k = 900, 24, 16, 10
    if lattice:
        x = rng.integers(-3, 4, (n, dim)).astype(np.float32)
        q = rng.integers(-3, 4, (B, dim)).astype(np.float32)
    else:
        x = rng.standard_normal((n, dim)).astype(np.float32)
        q = rng.standard_normal((B, dim)).astype(np.float32)
    live = rng.random(n) > 0.1
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    ji, js = JS.scan_topk_exact_l2(
        jnp.asarray(x), jnp.asarray(sq), jnp.asarray(live), jnp.asarray(q),
        k=k,
    )
    ti, ts = TS.scan_topk_exact_l2(
        torch.from_numpy(x), torch.from_numpy(sq), torch.from_numpy(live),
        torch.from_numpy(q), k=k,
    )
    ji, js, ti, ts = map(np.asarray, (ji, js, ti, ts))
    if lattice:
        assert np.array_equal(ti, ji) and np.array_equal(ts, js)
    else:
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        gap = np.abs(np.diff(js, axis=1)) > 1e-3
        sep = np.ones_like(ji, bool)
        sep[:, 1:] &= gap
        sep[:, :-1] &= gap
        assert np.array_equal(ti[sep], ji[sep])


def test_certified_matches_jax_and_exact(rng, monkeypatch):
    """REDIS_HNSW_TPU_SCAN_CERT=1 in both packages on tie-heavy lattice
    data: the certified replies are identical to the JAX package's and
    byte-identical to the port's exact tier; k > live rows certifies."""
    x = rng.integers(-2, 3, (700, 16)).astype(np.float32)
    q = rng.integers(-2, 3, (24, 16)).astype(np.float32)
    a, b = pair(x, 16)
    for i in range(0, 700, 3):
        a.delete_node(f"n{i}")
        b.delete_node(f"n{i}")
    want = b.search_batch(q, 10, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    before = dict(TS.CERT_STATS)
    got = b.search_batch(q, 10, reply="columnar")
    assert TS.CERT_STATS["batches"] == before["batches"] + 1
    assert TS.CERT_STATS["queries"] == before["queries"] + 24
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
    assert replies(b.search_batch(q, 10)) == replies(a.search_batch(q, 10))
    small_a, small_b = pair(x[:12], 16)
    for ra, rb in zip(small_a.search_batch(q[:2], 40),
                      small_b.search_batch(q[:2], 40)):
        assert len(rb) == 12
        assert [(r.sim, r.name) for r in ra] == [(r.sim, r.name) for r in rb]
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "2")
    with pytest.raises(ValueError, match="SCAN_CERT"):
        b.search_batch(q, 10)


def test_certified_tie_fallback(rng, monkeypatch):
    """Every row duplicated 8x: top-10 always cuts an 8-member tie
    class, so no query certifies and every query is re-served exactly
    (same tie members, lowest ids) -- as in the JAX package."""
    base = rng.standard_normal((60, 24)).astype(np.float32)
    data = np.repeat(base, 8, axis=0)
    q = rng.standard_normal((16, 24)).astype(np.float32)
    a, b = pair(data, 24)
    want = b.search_batch(q, 10, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    before = TS.CERT_STATS["fallback_queries"]
    got = b.search_batch(q, 10, reply="columnar")
    assert TS.CERT_STATS["fallback_queries"] >= before + 16
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
    jgot = a.search_batch(q, 10)
    assert [[r.name for r in row] for row in jgot] == got[0].tolist()


def test_certified_audit(rng, monkeypatch):
    """Every CERT_AUDIT_EVERY-th certified batch is re-served exactly
    and byte-compared; a sound certificate never mismatches."""
    data = rng.standard_normal((400, 24)).astype(np.float32)
    q = rng.standard_normal((8, 24)).astype(np.float32)
    _, b = pair(data, 24)
    want = replies(b.search_batch(q, 10))
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setattr(TS, "CERT_AUDIT_EVERY", 1)
    audits = TS.CERT_STATS.get("audits", 0)
    got = replies(b.search_batch(q, 10))
    assert TS.CERT_STATS["audits"] == audits + 1
    assert TS.CERT_STATS.get("audit_mismatches", 0) == 0
    assert got == want


def test_certified_rerun_sink_across_chunks(rng, monkeypatch):
    """Chunked serving (MAX_LANES shrunk to 8): one uncertified query
    per chunk is deferred to the CertRerunSink and patched at flush --
    the reply is byte-identical to the exact tier's."""
    base = rng.standard_normal((500, 24)).astype(np.float32)
    data = np.concatenate([base, np.repeat(base[:5], 11, axis=0)])
    q = rng.standard_normal((40, 24)).astype(np.float32)
    for j, row in enumerate(range(0, 40, 9)):
        q[row] = base[j] + 1e-3  # its nearest row has 12 copies
    _, b = pair(data, 24)
    monkeypatch.setattr(TSearch, "MAX_LANES", 8)
    want = b.search_batch(q, 10, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    deferred = []
    add = TS.CertRerunSink.add

    def spy(self, exact, qd, bad, *rest):
        deferred.extend(bad)
        return add(self, exact, qd, bad, *rest)

    monkeypatch.setattr(TS.CertRerunSink, "add", spy)
    before = TS.CERT_STATS["fallback_queries"]
    got = b.search_batch(q, 10, reply="columnar")
    assert TS.CERT_STATS["fallback_queries"] >= before + 5
    assert len(deferred) >= 5
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))


def test_cert_enabled_gates_match_jax(monkeypatch):
    monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT", raising=False)
    monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT_MAX_DIM", raising=False)
    assert TS.CERT_MIN_ROWS == JS.CERT_MIN_ROWS
    assert TS.CERT_MAX_DIM == JS.CERT_MAX_DIM
    grid = [(TS.CERT_MIN_ROWS + d, dim) for d in (-1, 0, 5)
            for dim in (0, 128, 768, 960)]
    for env in (None, "1024", "junk"):
        if env is None:
            monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT_MAX_DIM",
                               raising=False)
        else:
            monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT_MAX_DIM", env)
        for n, dim in grid:
            assert TS.cert_enabled(n, dim) == JS.cert_enabled(n, dim)
    for v in ("0", "1"):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", v)
        assert TS.cert_enabled(8, 4096) == JS.cert_enabled(8, 4096)
    assert TS.scan_oversample() == JS.scan_oversample()
