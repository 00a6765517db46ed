"""The certified tier's fallback history (ops/scan.py ``CertHistory``) on
the CPU, with REDIS_HNSW_TPU_SCAN_CERT=1.

After a batch of a table epoch falls back whole (more than a quarter of
it uncertified), the port serves that epoch's later batches straight on
the exact tier, and one in CERT_PROBE_EVERY still takes the certified
tier as a probe. The JAX package certifies every batch. Held here: which
chunks call the certified select (kernel D's one-pass form, kernels A +
B, kernels A′ + B′), the counts (CERT_STATS ``skipped_queries`` and the
record's ``cert_skipped_queries`` against ``batches`` / ``queries``),
replies byte-equal to the exact tier's and to the JAX package's, a
certifying probe clearing the history, a new epoch starting clean, a
table that certifies never skipping, and the sharded index never
skipping. Lattice rows make every score exact, so the two packages'
replies compare byte for byte.
"""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
import redis_hnsw_tpu_torch.ops.scan as TS
import redis_hnsw_tpu_torch.ops.search as TSE
from redis_hnsw_tpu.models.flat import FlatIndex as JFlat
from redis_hnsw_tpu_torch.models.flat import FlatIndex as TFlat
from redis_hnsw_tpu_torch.parallel import ShardedHNSW as TShard
from redis_hnsw_tpu_torch.parallel import make_mesh
from redis_hnsw_tpu_torch.utils import profiling as P

LANES = 32
KEYS = ("batches", "queries", "fallback_queries", "whole_batch_queries",
        "skipped_queries")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a chunk: one intra-op thread keeps them cheap under
    a parallel test run (the previous count is restored)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cert_on(monkeypatch):
    """The certified tier forced, 32-lane chunks, no audits (an audit
    batch is no failure, so it would move the counts by the worker's
    running batch count)."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    monkeypatch.setattr(TSE, "MAX_LANES", LANES)
    monkeypatch.setattr(TS, "CERT_AUDIT_EVERY", 0)


def tie_lattice(rng, n_base=160, dim=8):
    """Integer rows, each 8 times over in one 128-row bin, and queries on
    the rows: at k = 5 the tie class at the top is cut on every query, so
    no query certifies, in either euclidean form."""
    base = rng.integers(-4, 5, (n_base, dim)).astype(np.float32)
    return np.repeat(base, 8, axis=0), base


def names(n, p="n"):
    return [f"{p}{i}" for i in range(n)]


def flat(data, cls=TFlat, **kw):
    dim = data.shape[1] * (32 if data.dtype == np.uint32 else 1)
    metric = "hamming" if data.dtype == np.uint32 else "euclidean"
    conf = (J if cls is JFlat else T).IndexConfig(dim=dim, metric=metric)
    idx = cls("f", conf, **kw)
    idx.add_batch(names(len(data)), data)
    return idx


def served(idx, qs, k, **kw):
    """The columnar reply and the request's record of one call."""
    with P.request():
        got = idx.search_batch(qs, k, reply="columnar", **kw)
    return got, {f: int(c[0]) for f, c in P.recent(1).items()}


def exact(monkeypatch, idx, qs, k, **kw):
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "0")
    out = idx.search_batch(qs, k, reply="columnar", **kw)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    return out


def same(a, b):
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(np.asarray(a[1], np.float32).view(np.int32),
                          np.asarray(b[1], np.float32).view(np.int32))


def delta(before):
    return {key: TS.CERT_STATS[key] - before[key] for key in KEYS}


def watch(monkeypatch, select="scan_certified_l2"):
    """Number every chunk served on one card and note those whose
    dispatch calls the certified ``select``: returns (chunks seen,
    certified chunk numbers), both filled as the searches run."""
    seen, cert = [0], []
    real_chunk, real_select = TS.serve_chunk, getattr(TS, select)

    def serve_chunk(*a, **kw):
        seen[0] += 1
        return real_chunk(*a, **kw)

    def certified(*a, **kw):
        cert.append(seen[0] - 1)
        return real_select(*a, **kw)

    monkeypatch.setattr(TS, "serve_chunk", serve_chunk)
    monkeypatch.setattr(TS, select, certified)
    return seen, cert


def model(n_chunks, requests, first):
    """The chunk numbers the rule certifies when every certified chunk
    falls back whole and the first finish comes after ``first`` chunks
    were dispatched: those, then one in CERT_PROBE_EVERY."""
    failing, waited, out = False, 0, []
    for g in range(n_chunks * requests):
        failing = failing or g >= first
        if not failing:
            out.append(g)
            continue
        waited += 1
        if waited == TS.CERT_PROBE_EVERY:
            waited = 0
            out.append(g)
    return out


@pytest.mark.parametrize("onepass", ["1", "0"])
@pytest.mark.parametrize("depth,window", [(0, 1), (2, 8)])
def test_skip_after_a_whole_batch_fallback(rng, monkeypatch, onepass, depth,
                                           window):
    """Two requests of 40 chunks on a tie-heavy lattice table: the chunks
    dispatched before the first whole-batch fallback finishes take the
    certified tier, then one in CERT_PROBE_EVERY; the rest are served on
    the exact tier and counted as skipped, in CERT_STATS and in each
    request's record, and in no certified count. Replies byte-equal to
    the exact tier's and the JAX package's."""
    monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", onepass)
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", str(depth))
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", str(window))
    data, base = tie_lattice(rng)
    qs = base[np.arange(40 * LANES) % len(base)]
    idx = flat(data, device="cpu")
    want = exact(monkeypatch, idx, qs, 5)
    jax_reply = flat(data, JFlat).search_batch(qs, 5, reply="columnar")
    same(want, jax_reply)
    seen, cert = watch(monkeypatch)
    before = dict(TS.CERT_STATS)
    recs = []
    for _ in range(2):
        got, rec = served(idx, qs, 5)
        same(got, want)
        recs.append(rec)
    expect = model(40, 2, (depth + 1) * window)
    assert seen[0] == 80 and cert == expect
    if (depth, window) == (0, 1):
        assert cert == [0, 16, 32, 48, 64]
    n_cert = LANES * len(expect)
    assert delta(before) == {
        "batches": len(expect), "queries": n_cert,
        "fallback_queries": n_cert, "whole_batch_queries": n_cert,
        "skipped_queries": LANES * 80 - n_cert}
    for r, rec in enumerate(recs):
        mine = LANES * sum(40 * r <= g < 40 * (r + 1) for g in expect)
        assert rec["queries"] == 40 * LANES and rec["chunks"] == 40
        assert rec["cert_queries"] == mine
        assert rec["whole_batch_queries"] == mine
        assert rec["cert_skipped_queries"] == 40 * LANES - mine
        assert rec["exact_queries"] == 0


def test_hnsw_scan_route_skips_too(rng, monkeypatch):
    """The HNSW index's scan route serves its chunks through the same
    state and rule: after its first chunk falls back whole, one chunk in
    CERT_PROBE_EVERY takes the certified tier; replies equal its exact
    tier's."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    data, base = tie_lattice(rng)
    qs = base[np.arange(20 * LANES) % len(base)]
    idx = T.HNSWIndex("h", T.IndexConfig(dim=8, m=8, ef_construction=32,
                                         seed=5), device="cpu")
    idx.add_batch(names(len(data)), data, batch_size=512)
    want = exact(monkeypatch, idx, qs, 5, engine="scan")
    seen, cert = watch(monkeypatch)
    before = dict(TS.CERT_STATS)
    got, rec = served(idx, qs, 5, engine="scan")
    same(got, want)
    assert seen[0] == 20 and cert == [0, 16]
    assert rec["cert_skipped_queries"] == 18 * LANES
    assert delta(before)["skipped_queries"] == 18 * LANES
    assert delta(before)["batches"] == 2


def mixed_table(rng, dim=8, bins=256):
    """Distinct Gaussian rows over ``bins`` bins, its first 128 rows 16
    rows 8 times over: queries on those 16 fail kernel D's certificate,
    Gaussian queries pass it but for a few (two of their top 5 in one
    bin)."""
    data = rng.standard_normal((128 * bins, dim)).astype(np.float32)
    dup = rng.standard_normal((16, dim)).astype(np.float32)
    data[:128] = np.repeat(dup, 8, axis=0)
    return data, dup


def test_a_certifying_probe_clears_the_history(rng, monkeypatch):
    """A tie-heavy request turns the history failing; in the next,
    Gaussian queries skip until the probe, which certifies (no whole
    fallback) and clears it, so every later chunk takes kernel D."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    data, dup = mixed_table(rng)
    idx = flat(data, device="cpu")
    ties = dup[np.arange(2 * LANES) % 16]
    gauss = rng.standard_normal((30 * LANES, 8)).astype(np.float32)
    want = exact(monkeypatch, idx, gauss, 5)
    seen, cert = watch(monkeypatch)
    served(idx, ties, 5)
    history = idx.scan_state().cert_history
    assert history.failing and cert == [0]  # chunk 1 skipped
    before = dict(TS.CERT_STATS)
    got, rec = served(idx, gauss, 5)
    same(got, want)
    # chunks 2-15 skipped, chunk 16 the probe, 17-31 certified
    assert cert == [0, *range(16, 32)]
    assert not history.failing
    assert rec["cert_skipped_queries"] == 14 * LANES
    d = delta(before)
    assert d["skipped_queries"] == 14 * LANES and d["batches"] == 16
    assert d["whole_batch_queries"] == 0
    assert 0 < d["fallback_queries"] < 16 * LANES // 4


@pytest.mark.parametrize("mutation", ["add", "delete"])
def test_a_new_epoch_starts_clean(rng, monkeypatch, mutation):
    """An insert or a delete starts a new epoch, whose scan state holds a
    new history: its first chunk takes the certified tier again."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    data, base = tie_lattice(rng)
    qs = base[np.arange(4 * LANES) % len(base)]
    idx = flat(data, device="cpu")
    seen, cert = watch(monkeypatch)
    served(idx, qs, 5)
    assert cert == [0] and idx.scan_state().cert_history.failing
    if mutation == "add":
        idx.add_node("extra", base[0] + 1)
    else:
        idx.delete_batch(["n7"])
    state = idx.scan_state()
    assert not state.cert_history.failing
    got, rec = served(idx, qs, 5)
    same(got, exact(monkeypatch, idx, qs, 5))
    assert cert == [0, 4]  # the new epoch's first chunk, then skips
    assert rec["cert_queries"] == LANES
    assert rec["cert_skipped_queries"] == 3 * LANES
    assert idx.scan_state() is state and state.cert_history.failing


def test_a_table_that_certifies_never_skips(rng, monkeypatch):
    """Gaussian rows over as many chunks: no batch falls back whole, so
    every chunk takes kernel D and nothing is skipped."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    data = rng.standard_normal((128 * 256, 8)).astype(np.float32)
    qs = rng.standard_normal((40 * LANES, 8)).astype(np.float32)
    idx = flat(data, device="cpu")
    want = exact(monkeypatch, idx, qs, 5)
    seen, cert = watch(monkeypatch)
    before = dict(TS.CERT_STATS)
    got, rec = served(idx, qs, 5)
    same(got, want)
    assert cert == list(range(40))
    assert rec["cert_skipped_queries"] == 0
    d = delta(before)
    assert d["skipped_queries"] == 0 and d["whole_batch_queries"] == 0
    assert d["batches"] == 40 and d["queries"] == 40 * LANES


def words(rng, n, w=8):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def test_hamming_certified_tier_follows_the_rule(rng, monkeypatch):
    """The certified hamming tier (kernels A′ and B′) on 12 codes 48
    times over, queried on the codes: every chunk falls back whole, so
    after the first one chunk in CERT_PROBE_EVERY calls its select.
    Replies byte-equal to the exact tier's and the JAX package's."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    base = words(rng, 12)
    data = np.repeat(base, 48, axis=0)
    qs = base[np.arange(20 * LANES) % 12]
    idx = flat(data, device="cpu")
    want = exact(monkeypatch, idx, qs, 10)
    same(want, flat(data, JFlat).search_batch(qs, 10, reply="columnar"))
    seen, cert = watch(monkeypatch, "scan_certified_hamming")
    before = dict(TS.CERT_STATS)
    got, rec = served(idx, qs, 10)
    same(got, want)
    assert seen[0] == 20 and cert == [0, 16]
    assert rec["cert_skipped_queries"] == 18 * LANES
    d = delta(before)
    assert d["batches"] == 2 and d["whole_batch_queries"] == 2 * LANES
    assert d["skipped_queries"] == 18 * LANES


def test_the_sharded_index_never_skips(rng, monkeypatch):
    """The sharded route shares the fallback rule but keeps no history:
    every chunk of a tie-heavy table is certified and served again."""
    monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
    monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
    data, base = tie_lattice(rng, n_base=40)
    qs = base[np.arange(5 * LANES) % len(base)]
    idx = TShard("s", T.IndexConfig(dim=8, m=8, ef_construction=32, seed=5),
                 mesh=make_mesh(2, device="cpu"))
    idx.add_batch(names(len(data)), data)
    want = exact(monkeypatch, idx, qs, 5, engine="scan")
    before = dict(TS.CERT_STATS)
    got = idx.search_batch(qs, 5, engine="scan", reply="columnar")
    same(got, want)
    d = delta(before)
    assert d["skipped_queries"] == 0
    assert d["batches"] == 5 and d["queries"] == 5 * LANES
    assert d["whole_batch_queries"] >= LANES
