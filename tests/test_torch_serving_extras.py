"""Serving extras of the port against the JAX package, on the CPU: the
scan-approx tier and ``recall_target`` routing, ids-only replies,
``tune``, the TEXMEX dataset files and ``device_trace``.

The JAX package's scan-approx tier selects with ``jax.lax.approx_max_k``,
exact off the TPU; the port serves the tier on kernel A's exact select,
so both give the same replies (ties planted across the JAX scan's chunk
edges included). Under REDIS_HNSW_TPU_REPLY=ids-force both packages copy
only the ids and rescore the sims on the host: the ids are equal, the
sims equal to f32 rounding (rtol 1e-5; Gaussian rows), and the port's
equal its full reply's bit for bit. Tolerance elsewhere: none (lattice
rows, exact in f32).
"""

import json
import os

import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.ops import scan as JS
from redis_hnsw_tpu.utils import datasets as JD
from redis_hnsw_tpu_torch.ops import cuda_scan
from redis_hnsw_tpu_torch.ops import distance as D
from redis_hnsw_tpu_torch.ops import scan as TS
from redis_hnsw_tpu_torch.utils import datasets as TD

CHUNK = 128  # the JAX scan's row chunk, shrunk so tables span many


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages score in CHUNK-row chunks (the JAX scan's jitted
    programs are re-traced at this chunk, before and after)."""
    for fn in (JS.scan_topk, JS.scan_topk_exact_l2):
        fn.clear_cache()
    monkeypatch.setattr(JS, "CHUNK_N", CHUNK)
    monkeypatch.setattr(cuda_scan, "CHUNK_N", CHUNK)
    yield
    for fn in (JS.scan_topk, JS.scan_topk_exact_l2):
        fn.clear_cache()


def tie_data(metric, n, seed=0):
    """Lattice rows (or random words) with equal rows planted on both
    sides of every chunk edge, and queries aimed at them."""
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        data = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    else:
        data = rng.integers(-3, 4, (n, 8)).astype(np.float32)
    edges = [e for e in range(CHUNK, n, CHUNK)]
    for e in edges:
        data[e - 2: e + 2] = data[e - 2]
    qs = data[[e - 1 for e in edges] + list(range(0, n, 37))].copy()
    if metric == "hamming":
        qs[::2, 0] ^= np.uint32(3)
    else:
        qs[::2] += 0.5
    return data, qs


def client_pair(kind, metric, data, seed=3):
    dim = 64 if metric == "hamming" else 8
    names = [f"n{i}" for i in range(len(data))]
    ca, cb = J.HNSW(), T.HNSW(device="cpu")
    for c in (ca, cb):
        c.create_index("x", dim=dim, m=5, ef_construction=32, seed=seed,
                       metric=metric, kind=kind)
        c.add_batch("x", names, data)
        c.delete_batch("x", names[5::41])
    return ca, cb


def norm(res):
    return [[(r.name, r.sim) for r in rr] for rr in res]


@pytest.mark.parametrize("kind", ["hnsw", "flat"])
@pytest.mark.parametrize("metric", ["euclidean", "hamming"])
def test_scan_approx_and_recall_target_match_jax(small_chunks, kind,
                                                 metric):
    n = 1100 if kind == "flat" else 300  # 8 full chunks: JAX's loop path
    data, qs = tie_data(metric, n)
    ca, cb = client_pair(kind, metric, data)
    for k in (1, 4, 13):
        want = norm(ca.search_batch("x", qs, k=k, engine="scan-approx"))
        exact = norm(cb.search_batch("x", qs, k=k, engine="scan"))
        assert norm(cb.search_batch("x", qs, k=k,
                                    engine="scan-approx")) == want
        assert exact == want  # the tier is exact here
        for rt in (0.5, 0.99, 0.999):
            assert norm(cb.search_batch("x", qs, k=k,
                                        recall_target=rt)) == want
        assert norm(cb.search_batch("x", qs, k=k, recall_target=1.0)) == (
            norm(ca.search_batch("x", qs, k=k, recall_target=1.0)))
    if kind == "flat":
        with pytest.raises(ValueError, match="unavailable on flat"):
            cb.search_batch("x", qs, engine="graph")
    else:
        with pytest.raises(ValueError, match="tune"):
            cb.search_batch("x", qs, engine="graph", recall_target=0.9)


def test_scan_approx_skips_the_certificate(monkeypatch):
    """The approx tier serves on the exact tier even where the certified
    tier would (a recall target is not a certificate)."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
    data, qs = tie_data("euclidean", 400)
    ca, cb = client_pair("flat", "euclidean", data)
    batches = TS.CERT_STATS["batches"]
    got = norm(cb.search_batch("x", qs, k=5, engine="scan-approx"))
    assert TS.CERT_STATS["batches"] == batches
    assert got == norm(ca.search_batch("x", qs, k=5, engine="scan-approx"))
    assert got == norm(cb.search_batch("x", qs, k=5))
    assert TS.CERT_STATS["batches"] > batches


def gaussian_pair(kind, n=700, dim=24, seed=1):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((40, dim)).astype(np.float32)
    names = [f"g{i}" for i in range(n)]
    ca, cb = J.HNSW(), T.HNSW(device="cpu")
    for c in (ca, cb):
        c.create_index("g", dim=dim, m=6, ef_construction=40, seed=2,
                       kind=kind)
        c.add_batch("g", names, data)
    return ca, cb, qs


def split(reply):
    names = [[n for n, _ in r] for r in reply]
    sims = np.array([[s for _, s in r] for r in reply], np.float32)
    return names, sims


@pytest.mark.parametrize("kind", ["hnsw", "flat"])
def test_ids_force_replies_match_jax(monkeypatch, kind):
    """Under ids-force the port's replies carry the JAX package's ids,
    and sims equal to f32 rounding (the port's host rescore sums in
    ``_sum_last``'s order, the JAX package's in a library reduction;
    rtol 1e-5, as tests/test_torch_scan.py holds direct-form sims) --
    and they equal the port's own full reply bit for bit, since the host
    sums as the device does. A flat reply carries its sims under any
    REDIS_HNSW_TPU_REPLY, as in the JAX package."""
    ca, cb, qs = gaussian_pair(kind)
    engines = ("scan", "scan-approx") + (("graph",) if kind == "hnsw" else ())
    kws = {e: dict(k=10, engine=e) for e in engines}
    if kind == "hnsw":
        kws["graph"].update(ef_search=40, expand=2)
    full = {e: norm(cb.search_batch("g", qs, **kws[e])) for e in engines}
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
    for engine in engines:
        got = norm(cb.search_batch("g", qs, **kws[engine]))
        want = norm(ca.search_batch("g", qs, **kws[engine]))
        assert got == full[engine], engine
        assert split(got)[0] == split(want)[0], engine
        np.testing.assert_allclose(split(got)[1], split(want)[1],
                                   rtol=1e-5)
    # a device query block with a host mirror takes the same path
    got = norm(cb.index("g").search_batch(torch.from_numpy(qs), 10,
                                          host_qs=qs))
    assert got == full["scan"]


def test_ids_force_hits_the_host_rescore(monkeypatch):
    """ids-force copies no sims off the device: the reply's sims come
    from the host rescore (counted here), on both engines; hamming never
    takes the path."""
    _, cb, qs = gaussian_pair("hnsw", n=300)
    calls = []
    orig = TS.host_exact_sims
    monkeypatch.setattr(TS, "host_exact_sims",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
    cb.search_batch("g", qs, k=5, engine="scan")
    cb.search_batch("g", qs, k=5, engine="graph", ef_search=32)
    assert len(calls) == 2
    cb.search_batch("g", torch.from_numpy(qs), k=5)  # no host mirror
    assert len(calls) == 2
    cb.create_index("h", dim=64, metric="hamming")
    cb.add_batch("h", ["a", "b"], np.array([[0, 1], [1, 1]], np.uint32))
    cb.search_batch("h", np.zeros((1, 2), np.uint32), k=2)
    assert len(calls) == 2


def test_ids_guard(monkeypatch, caplog):
    """"ids" is guarded by the calibrated slopes: on a CPU index the copy
    costs nothing, so the guard turns it off (the full reply serves);
    with a costly copy it engages at low dims only; ids-force and full
    skip it; a bad value raises."""
    monkeypatch.setattr(TS, "_IDS_GUARD", {})
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids")
    assert TS.reply_ids_engaged(24, torch.device("cpu")) is False
    spb, spe = TS._IDS_GUARD[("cal", "cpu")]
    assert spb < 1e-9 and spe > 0
    _, cb, qs = gaussian_pair("hnsw", n=200)
    got = norm(cb.search_batch("g", qs, k=5))
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "full")
    assert got == norm(cb.search_batch("g", qs, k=5))
    monkeypatch.setattr(TS, "_IDS_GUARD", {("cal", "cpu"): (1e-6, 1e-8)})
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids")
    caplog.clear()
    with caplog.at_level("WARNING"):
        assert TS.reply_ids_engaged(128, "cpu") is True
        assert TS.reply_ids_engaged(960, "cpu") is False
    assert "ids-force" in caplog.text
    assert TS._IDS_GUARD[("cpu", 128)] is True
    assert TS._IDS_GUARD[("cpu", 960)] is False
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
    assert TS.reply_ids_engaged(960, "cpu") is True
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "full")
    assert TS.reply_ids_engaged(8, "cpu") is False
    assert TS.reply_ids_only() is False
    monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "bogus")
    with pytest.raises(ValueError, match="REDIS_HNSW_TPU_REPLY"):
        cb.search_batch("g", qs, k=5)


def test_host_rescore_helpers_match_jax():
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((50, 12)).astype(np.float32)
    qs = rng.standard_normal((6, 12)).astype(np.float32)
    ids = rng.integers(-1, 50, (6, 7)).astype(np.int32)
    want = JS.host_exact_sims(vecs, qs, ids)
    got = TS.host_exact_sims(vecs, qs, ids)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.array_equal(np.isneginf(got), ids < 0)
    # the host rescore gives the device rescore's bits
    safe = torch.from_numpy(np.maximum(ids, 0)).long()
    dev = D.exact_neg_sq_l2(torch.from_numpy(qs), torch.from_numpy(vecs),
                            safe, torch.from_numpy(ids >= 0))
    assert got.tobytes() == dev.numpy().tobytes()
    order = np.lexsort((ids, -got), axis=-1)
    for a, b in zip(TS.sort_reply(ids, got),
                    (np.take_along_axis(ids, order, -1),
                     np.take_along_axis(got, order, -1))):
        assert a.tobytes() == b.tobytes()


def test_tune_matches_jax():
    """tune() picks the same knobs, with the same recall, as the JAX
    package's on the same lattice graph (its exact oracle is the exact
    scan, kernel A on the card)."""
    rng = np.random.default_rng(8)
    data = rng.integers(-4, 5, (400, 16)).astype(np.float32)
    qs = rng.integers(-4, 5, (24, 16)).astype(np.float32) + 0.5
    names = [f"n{i}" for i in range(400)]
    kw = dict(dim=16, m=4, ef_construction=24, seed=6)
    a = J.HNSWIndex("t", J.IndexConfig(**kw))
    b = T.HNSWIndex("t", T.IndexConfig(**kw), device="cpu")
    for x in (a, b):
        x.add_batch(names, data, batch_size=64)
    knobs = dict(k=10, target_recall=0.97, expand=4, ef_ladder=(8, 16, 32))
    got, want = T.tune(b, qs, **knobs), J.tune(a, qs, **knobs)
    strip = lambda d: {key: v for key, v in d.items() if key != "qps"}
    assert strip(got) == strip(want)
    assert got["ef_search"] in (16, 32)  # the ladder was climbed
    from redis_hnsw_tpu.utils.autotune import _exact_topk as j_truth
    from redis_hnsw_tpu_torch.utils.autotune import _exact_topk as t_truth

    assert [set(r) for r in t_truth(b, qs, 10)] == [
        set(r) for r in j_truth(a, qs, 10)]


def test_datasets_cross_read(tmp_path):
    rng = np.random.default_rng(9)
    base = rng.standard_normal((33, 7)).astype(np.float32)
    query = rng.standard_normal((5, 7)).astype(np.float32)
    for writer, reader in ((JD.write_fvecs, TD), (TD.write_fvecs, JD)):
        bp, qp = str(tmp_path / "b.fvecs"), str(tmp_path / "q.fvecs")
        writer(bp, base)
        writer(qp, query)
        np.testing.assert_array_equal(reader.read_fvecs(bp), base)
        np.testing.assert_array_equal(reader.read_fvecs(bp, count=4),
                                      base[:4])
        b2, q2 = reader.load_pair(f"fvecs:{bp}:{qp}")
        np.testing.assert_array_equal(b2, base)
        np.testing.assert_array_equal(q2, query)
    assert open(bp, "rb").read() == open(str(tmp_path / "b.fvecs"),
                                         "rb").read()
    raw = np.zeros((3, 1 + 4), np.int32)
    raw[:, 0] = 16
    raw[:, 1:] = rng.integers(0, 2**31 - 1, (3, 4))
    path = str(tmp_path / "x.bvecs")
    raw.tofile(path)
    for pkg in (TD, JD):
        got = pkg.read_bvecs(path)
        assert got.dtype == np.float32 and got.shape == (3, 16)
    np.testing.assert_array_equal(TD.read_bvecs(path), JD.read_bvecs(path))
    ip = str(tmp_path / "gt.ivecs")
    gt = np.concatenate([np.full((4, 1), 3, np.int32),
                         rng.integers(0, 99, (4, 3)).astype(np.int32)], 1)
    gt.tofile(ip)
    np.testing.assert_array_equal(TD.read_ivecs(ip), gt[:, 1:])
    np.testing.assert_array_equal(TD.read_ivecs(ip), JD.read_ivecs(ip))
    (tmp_path / "bad.fvecs").write_bytes(b"\x04\x00\x00\x00abc")
    with pytest.raises(ValueError, match="not a multiple"):
        TD.read_fvecs(str(tmp_path / "bad.fvecs"))
    with pytest.raises(ValueError, match="must be"):
        TD.load_pair("fvecs:only")


def test_device_trace_writes_a_trace(tmp_path):
    from redis_hnsw_tpu_torch.utils.profiling import device_trace

    c = T.HNSW(device="cpu")
    c.create_index("p", dim=8, seed=1)
    c.add_batch("p", [f"n{i}" for i in range(40)],
                np.arange(320, dtype=np.float32).reshape(40, 8))
    with device_trace(str(tmp_path / "tr"), device="cpu") as prof:
        c.search_batch("p", np.zeros((4, 8), np.float32), k=3)
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path / "tr")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_device_trace_refuses_without_a_card(tmp_path, monkeypatch):
    from redis_hnsw_tpu_torch.utils.profiling import device_trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(T.HNSWError, match="no CUDA device"):
        with device_trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)
