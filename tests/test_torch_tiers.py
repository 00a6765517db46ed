"""The bf16 and int8 scan tiers of the port against the JAX package, on
the CPU (REDIS_HNSW_TPU_SCAN_DTYPE, REDIS_HNSW_TPU_INT8_RESCORE).

The same seeded rows go through both packages; the kernels' plain
versions serve the port here. Tolerances:

* the quantizers (``_to_bf16``, ``_to_int8``, the flat host quantizer):
  byte-equal on Gaussian data;
* lattice rows (integer coordinates, |v| <= 16, exact in bf16 and in
  every f32 sum): replies byte-equal, ids and sims, for the HNSW scan
  path (``scan`` and ``scan-approx``) and the flat index (bf16, and the
  int8-resident tier at INT8_RESCORE 1 and 8);
* Gaussian rows (the JAX tests' 500 x 24, 24 queries, k = 10): per-query
  id overlap with the JAX package's reply >= 0.99 (bf16) / 0.98 (int8),
  and >= 0.97 / 0.95 against the f32 oracle as the JAX tests assert;
  sims of shared ids within rtol 1e-5 (the port sums query norms and
  direct-form rescores in ``_sum_last``'s fixed order, the JAX package
  with a library sum: a few ulp).
"""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.ops import scan as JS
from redis_hnsw_tpu_torch.models.flat import quantize_rows
from redis_hnsw_tpu_torch.ops import scan as TS

N, DIM, NQ, K = 500, 24, 24, 10
NAMES = [f"n{i}" for i in range(N)]


def lattice(rng, n):
    return rng.integers(-16, 17, (n, DIM)).astype(np.float32)


def clients(data, deleted=()):
    """A JAX client and a port client (CPU), each holding HNSW index "g"
    (add_batch) and flat index "f" of ``data``, with ``deleted`` rows
    deleted from both."""
    out = []
    for mod, kw in ((J, {}), (T, dict(device="cpu"))):
        c = mod.HNSW(**kw)
        c.create_index("g", dim=DIM, m=8, ef_construction=32, seed=3)
        c.create_index("f", dim=DIM, kind="flat")
        for name in "gf":
            c.add_batch(name, NAMES, data)
            if deleted:
                c.delete_batch(name, [NAMES[i] for i in deleted])
        out.append(c)
    return out


@pytest.fixture(scope="module")
def lattice_pair():
    rng = np.random.default_rng(11)
    data = lattice(rng, N)
    data[200:204] = data[100]  # a tie class
    qs = lattice(rng, NQ)
    qs[0] = data[100]
    return clients(data, deleted=range(3, N, 29)), qs


@pytest.fixture(scope="module")
def gauss_pair():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((N, DIM)).astype(np.float32)
    qs = rng.standard_normal((NQ, DIM)).astype(np.float32)
    return clients(data), data, qs


def same_bytes(a, b):
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(np.asarray(a[1]).view(np.int32),
                          np.asarray(b[1]).view(np.int32))


def replies(c, qs, kinds):
    out = []
    for kind in kinds:
        if kind in ("scan", "scan-approx"):
            out.append(c.search_batch("g", qs, k=K, engine=kind,
                                      reply="columnar"))
        else:
            out.append(c.index("f").search_batch(qs, K, reply="columnar"))
    return out


def test_quantizers_byte_equal():
    """``_to_bf16`` and ``_to_int8`` give the JAX package's tables byte
    for byte on Gaussian rows, an all-zero row (scale 1) and a row whose
    quotients sit exactly on .5 (amax 127: scale 1, ties to even); so
    does the flat tier's chunked host quantizer against the JAX flat
    index's int8-resident upload."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, DIM)).astype(np.float32)
    x[7] = 0.0
    x[8, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5]
    q8, s = TS._to_int8(torch.from_numpy(x))
    jq8, js = JS._to_int8(x)
    assert np.array_equal(q8.numpy(), np.asarray(jq8))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    assert s[7] == 1.0 and q8[7].eq(0).all()
    assert q8[8, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]
    b16 = TS._to_bf16(torch.from_numpy(x)).view(torch.int16).numpy()
    jb16 = np.asarray(JS._to_bf16(x)).view(np.int16)
    assert np.array_equal(b16, jb16)

    hq8, hs = quantize_rows(x)
    assert np.array_equal(hq8, q8.numpy())
    import os

    os.environ["REDIS_HNSW_TPU_SCAN_DTYPE"] = "int8"
    try:
        jf = J.FlatIndex("q", J.IndexConfig(dim=DIM))
        tf = T.FlatIndex("q", T.IndexConfig(dim=DIM), device="cpu")
        for f in (jf, tf):
            f.add_batch([f"r{i}" for i in range(300)], x)
        jt, jsq, jv, jsc = jf._device()
        tt, tsq, tv, tsc = tf._device()
    finally:
        del os.environ["REDIS_HNSW_TPU_SCAN_DTYPE"]
    assert tt.dtype == torch.int8 and tt.shape == (384, DIM)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for a, b in ((tsc, jsc), (tsq, jsq)):
        assert np.array_equal(a.numpy().view(np.int32),
                              np.asarray(b).view(np.int32))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(hs.view(np.int32), tsc[:300].numpy().view(np.int32))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_lattice_replies_byte_equal(monkeypatch, lattice_pair, dtype):
    """On lattice rows every tier reply equals the JAX package's byte for
    byte: the HNSW scan path (scan, scan-approx) through the clients, the
    flat index under bf16, and the int8-resident flat tier at
    INT8_RESCORE 1 and 8 (deleted rows masked)."""
    (jc, tc), qs = lattice_pair
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
    kinds = ["scan", "scan-approx", "flat"]
    for mult in ("1", "8"):
        monkeypatch.setenv("REDIS_HNSW_TPU_INT8_RESCORE", mult)
        for got, want in zip(replies(tc, qs, kinds), replies(jc, qs, kinds)):
            same_bytes(got, want)
            assert not any(str(n) in {f"n{i}" for i in range(3, N, 29)}
                           for n in got[0].ravel())
    # the tie class of query 0 comes back in id order
    names = tc.search_batch("g", qs[:1], k=5, engine="scan",
                            reply="columnar")[0][0]
    assert names.tolist() == ["n100", "n200", "n201", "n202", "n203"]


def overlap(a, b):
    return np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)])


def f32_oracle(data, qs):
    d = ((qs[:, None, :].astype(np.float64) - data[None]) ** 2).sum(-1)
    return np.array(NAMES)[np.argsort(d, axis=1, kind="stable")[:, :K]]


@pytest.mark.parametrize("dtype,floor_jax,floor_f32", [
    ("bf16", 0.99, 0.97), ("int8", 0.98, 0.95)])
def test_gaussian_replies_close(monkeypatch, gauss_pair, dtype, floor_jax,
                                floor_f32):
    """On Gaussian rows each tier's replies overlap the JAX package's and
    the f32 oracle's as stated in the module docstring, shared ids carry
    the same sims to rtol 1e-5, and every reply is sorted."""
    (jc, tc), data, qs = gauss_pair
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
    want_f32 = f32_oracle(data, qs)
    kinds = ["scan", "scan-approx", "flat"]
    for got, want in zip(replies(tc, qs, kinds), replies(jc, qs, kinds)):
        assert overlap(got[0], want[0]) >= floor_jax
        assert overlap(got[0], want_f32) >= floor_f32
        for gn, gs, wn, ws in zip(*got, *want):
            assert np.all(gs[:-1] >= gs[1:])
            wmap = dict(zip(wn, ws))
            for n, s in zip(gn, gs):
                if n in wmap:
                    np.testing.assert_allclose(s, wmap[n], rtol=1e-5)


def test_tier_cache_rebuilds_on_switch(monkeypatch, lattice_pair):
    """The HNSW scan state is cached by (snapshot epoch, tier): a switch
    of tiers at the same epoch rebuilds the selection table; the f32
    rescore table is the snapshot's in every tier."""
    (_, tc), qs = lattice_pair
    idx = tc.index("g")
    tables = {}
    for dtype in ("bf16", "int8", "f32", "bf16"):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
        tc.search_batch("g", qs, k=K, engine="scan")
        key, (table, vecs, sqn, live, tscale) = idx._scan_cache
        assert key == (idx._snapshot_epoch, dtype)
        assert vecs is idx.device_snapshot().vecs
        tables[dtype] = table
        want = {"bf16": torch.bfloat16, "int8": torch.int8,
                "f32": torch.float32}[dtype]
        assert table.dtype == want and (tscale is not None) == (
            dtype == "int8")
        assert (table is vecs) == (dtype == "f32")
    assert tables["bf16"].dtype == torch.bfloat16


def test_resident_deletes_and_epochs(monkeypatch):
    """The int8-resident flat tier keeps only the int8 table on the card
    (f32 rows never uploaded), masks deleted rows, re-uploads after a
    write, and answers as the JAX package's tier does."""
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "int8")
    rng = np.random.default_rng(3)
    data = lattice(rng, 300)
    qs = data[:6] + 1.0
    got, want = (
        pkg.FlatIndex("r", pkg.IndexConfig(dim=DIM), **kw)
        for pkg, kw in ((T, dict(device="cpu")), (J, {}))
    )
    for f in (got, want):
        f.add_batch([f"r{i}" for i in range(300)], data)
    table, _, _, tscale = got._device()
    assert table.dtype == torch.int8 and tscale is not None
    for step in range(2):
        for f in (got, want):
            f.delete_batch([f"r{i}" for i in range(step, 6, 2)])
        g = got.search_batch(qs, K, reply="columnar")
        same_bytes(g, want.search_batch(qs, K, reply="columnar"))
        gone = {f"r{i}" for i in range(step + 1) for i in range(i, 6, 2)}
        assert not gone & set(g[0].ravel().tolist())
    # use_pallas=True serves the int8-resident tier's reply (the JAX
    # package scores the int8 table as f32 rows there: ROADMAP.md
    # section 3), equal to the JAX package's default int8 reply
    same_bytes(got.search_batch(qs, K, use_pallas=True, reply="columnar"),
               want.search_batch(qs, K, reply="columnar"))


def test_int8_rescore_ladder(monkeypatch):
    """REDIS_HNSW_TPU_INT8_RESCORE widens the int8-resident selection
    (the JAX package's tests/test_scan.py::test_int8_rescore_mult_ladder,
    on its quantization-hostile table): replies stay [B, k] and sorted,
    mult * k past the table clamps and is exact, and each width's ids
    equal the JAX package's."""
    n = 400
    rng = np.random.default_rng(2)
    data = rng.standard_normal((n, DIM)).astype(np.float32)
    data[::50] *= 64.0
    names = [f"n{i}" for i in range(n)]
    qs = rng.standard_normal((16, DIM)).astype(np.float32)
    exact = T.FlatIndex("ex", T.IndexConfig(dim=DIM), device="cpu")
    exact.add_batch(names, data)
    want = exact.search_batch(qs, K, reply="columnar")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "int8")
    got, ref = (
        pkg.FlatIndex("f8l", pkg.IndexConfig(dim=DIM), **kw)
        for pkg, kw in ((T, dict(device="cpu")), (J, {}))
    )
    for f in (got, ref):
        f.add_batch(names, data)
    hits = {}
    for mult in (1, 2, 8, 64):
        monkeypatch.setenv("REDIS_HNSW_TPU_INT8_RESCORE", str(mult))
        g = got.search_batch(qs, K, approx=True, reply="columnar")
        r = ref.search_batch(qs, K, approx=True, reply="columnar")
        assert g[0].shape == (16, K) and np.all(g[1][:, :-1] >= g[1][:, 1:])
        assert np.array_equal(g[0], r[0])
        np.testing.assert_allclose(g[1], r[1], rtol=1e-5)
        hits[mult] = sum(len(set(a) & set(b)) for a, b in zip(g[0], want[0]))
    assert hits[64] == 160 and hits[1] <= hits[8] <= 160


def test_env_grammar_errors(monkeypatch, lattice_pair):
    """Bad REDIS_HNSW_TPU_SCAN_DTYPE and REDIS_HNSW_TPU_INT8_RESCORE values
    raise the JAX package's ValueError text; hamming tables ignore the
    tier."""
    (_, tc), qs = lattice_pair
    for env, value, fns in (
        ("REDIS_HNSW_TPU_SCAN_DTYPE", "tf32", (TS.scan_dtype, JS.scan_dtype)),
        ("REDIS_HNSW_TPU_INT8_RESCORE", "zero",
         (TS.int8_rescore_mult, JS.int8_rescore_mult)),
    ):
        monkeypatch.setenv(env, value)
        msgs = []
        for fn in fns:
            with pytest.raises(ValueError) as err:
                fn()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] == f"{env}={value!r}"
        monkeypatch.delenv(env)
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "tf32")
    with pytest.raises(ValueError, match="SCAN_DTYPE"):
        tc.search_batch("g", qs, k=K, engine="scan")
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", "int8")
    monkeypatch.setenv("REDIS_HNSW_TPU_INT8_RESCORE", "0")
    assert TS.int8_rescore_mult() == 1 == JS.int8_rescore_mult()
    h = T.HNSW(device="cpu")
    h.create_index("h", dim=64, metric="hamming", kind="flat")
    h.add_batch("h", ["a", "b"], np.array([[0, 1], [0, 0]], np.uint32))
    got = h.index("h").search_batch(np.zeros((1, 2), np.uint32), 2)[0]
    assert [(r.name, r.sim) for r in got] == [("b", 0.0), ("a", -1.0)]


def test_ids_only_replies_on_tiers(monkeypatch, lattice_pair):
    """REDIS_HNSW_TPU_REPLY=ids-force on a tier copies only the ids and
    rescores on the host: the reply equals the tier's full reply."""
    (_, tc), qs = lattice_pair
    for dtype in ("bf16", "int8"):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
        full = tc.search_batch("g", qs, k=K, engine="scan", reply="columnar")
        monkeypatch.setenv("REDIS_HNSW_TPU_REPLY", "ids-force")
        same_bytes(tc.search_batch("g", qs, k=K, engine="scan",
                                   reply="columnar"), full)
        monkeypatch.delenv("REDIS_HNSW_TPU_REPLY")


@pytest.mark.parametrize("dtype,width", [("bf16", 18), ("int8", 20)])
def test_tier_tables_padded_to_4_bytes(monkeypatch, dtype, width):
    """At an odd width (D = 17) the tier tables are stored with their rows
    zero-padded to 4 bytes once, where they are built (the HNSW scan
    state, the flat bf16 copy, the int8-resident upload); replies still
    equal the JAX package's byte for byte on lattice rows, and a core
    given an unpadded table raises."""
    from redis_hnsw_tpu_torch.ops import cuda_scan

    dim, n = 17, 300
    rng = np.random.default_rng(17)
    data = rng.integers(-16, 17, (n, dim)).astype(np.float32)
    qs = rng.integers(-16, 17, (8, dim)).astype(np.float32)
    names = [f"p{i}" for i in range(n)]
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
    got = []
    for mod, kw in ((T, dict(device="cpu")), (J, {})):
        c = mod.HNSW(**kw)
        c.create_index("g", dim=dim, m=8, ef_construction=32, seed=3)
        c.create_index("f", dim=dim, kind="flat")
        for name in "gf":
            c.add_batch(name, names, data)
        got.append([c.search_batch("g", qs, k=K, engine="scan",
                                   reply="columnar"),
                    c.index("f").search_batch(qs, K, reply="columnar")])
        if mod is T:
            tables = [c.index("g")._scan_cache[1][0]]
            f = c.index("f")
            tables.append(f.scan_state()[0])
    for a, b in zip(*got):
        same_bytes(a, b)
    for table in tables:
        assert table.shape[1] == width and not table[:, dim:].any()
    table = tables[0]
    sqm = cuda_scan.euclid_sq_masked(torch.zeros(len(table)),
                                     torch.ones(len(table), dtype=bool))
    qd = torch.from_numpy(qs)
    args = [qd.to(torch.bfloat16), table[:, :dim], sqm, torch.zeros(8)]
    fn = cuda_scan.flat_topk_bf16
    if dtype == "int8":
        q8, qscale = TS._to_int8(qd)
        args = [q8, qscale, table[:, :dim], torch.ones(len(table)), sqm,
                torch.zeros(8)]
        fn = cuda_scan.flat_topk_int8
    with pytest.raises(ValueError, match="pad_lowp_rows"):
        fn(*args, k=K)
