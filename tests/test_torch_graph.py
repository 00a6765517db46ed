"""The graph engine of the port against the JAX package, on the CPU.

Identical seeded host graphs (byte-equal since the host layer was
ported) go through ``redis_hnsw_tpu`` and ``redis_hnsw_tpu_torch``:

* the snapshots' frontier tiers (``nbrvec``, ``nbrsqn``, ``qrows``) are
  byte-equal after a full build and after a dirty-row delta, for every
  tier ``REDIS_HNSW_TPU_NBRVEC_DTYPE`` / ``REDIS_HNSW_TPU_QUANT`` selects;
* the descent, the beam (parity and expanded, eager and lazy, with and
  without seeds) and ``search_batch(engine="graph")`` give equal ids and
  bitwise-equal sims;
* kernel C's plain version equals the Pallas kernel (interpret mode) and
  ``block_neg_sq_l2`` bit for bit.

Integer-lattice data make every f32 score exact, so results compare
exactly, ties included. The int8 scorers are held to a tolerance: the
JAX package's XLA program contracts ``a * b - c`` into one FMA on the
CPU, while the port rounds the product on its own (the written form).
Property checks on Gaussian data mirror tests/test_search_device.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import redis_hnsw_tpu as J
import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu.ops import distance as JD
from redis_hnsw_tpu.ops import search as JS
from redis_hnsw_tpu.ops.pallas_gather import fused_block_score as pallas_score
from redis_hnsw_tpu_torch.ops import cuda_gather
from redis_hnsw_tpu_torch.ops import distance as TD
from redis_hnsw_tpu_torch.ops import search as TS

TIERS = {
    "f32": {"REDIS_HNSW_TPU_NBRVEC_DTYPE": "f32"},
    "f16": {"REDIS_HNSW_TPU_NBRVEC_DTYPE": "f16"},
    "bf16": {"REDIS_HNSW_TPU_NBRVEC_DTYPE": "bf16"},
    "i8": {"REDIS_HNSW_TPU_NBRVEC_DTYPE": "i8"},
    "off": {"REDIS_HNSW_TPU_NBRVEC_DTYPE": "off"},
    "quant": {"REDIS_HNSW_TPU_QUANT": "1"},
}


def lattice(rng, n, dim):
    return rng.integers(-4, 5, (n, dim)).astype(np.float32)


def build_pair(data, m=6, efcon=48, seed=5):
    dim = data.shape[1]
    a = J.HNSWIndex("g", J.IndexConfig(dim=dim, m=m, ef_construction=efcon,
                                       seed=seed))
    b = T.HNSWIndex("g", T.IndexConfig(dim=dim, m=m, ef_construction=efcon,
                                       seed=seed), device="cpu")
    for i, row in enumerate(data):
        a.add_node(f"n{i}", row)
        b.add_node(f"n{i}", row)
    return a, b


def same_bytes(ja, tt) -> bool:
    """A JAX array and a torch tensor hold the same shape and bytes."""
    if ja is None or tt is None:
        return ja is None and tt is None
    arr = np.asarray(ja)
    return (
        arr.shape == tuple(tt.shape)
        and arr.dtype.itemsize == tt.element_size()
        and arr.tobytes()
        == tt.contiguous().view(torch.uint8).numpy().tobytes()
    )


def same_reply(ra, rb):
    """Columnar replies: names equal, sims bitwise equal."""
    assert np.array_equal(ra[0], rb[0])
    assert ra[1].shape == rb[1].shape
    assert np.array_equal(ra[1].view(np.int32), rb[1].view(np.int32))


def set_tier(monkeypatch, tier):
    for key, value in TIERS[tier].items():
        monkeypatch.setenv(key, value)


@pytest.fixture(scope="module")
def pair():
    """One lattice index on each side, 300 x 16, and a query block."""
    rng = np.random.default_rng(21)
    data = lattice(rng, 300, 16)
    qs = lattice(rng, 37, 16)
    a, b = build_pair(data)
    return a, b, data, qs


# -- snapshots -----------------------------------------------------------------

def snapshot_fields_equal(sa, sb):
    for field in ("vecs", "sqnorms", "adj0", "adj_up", "upper_of",
                  "nbrvec", "nbrsqn", "qrows"):
        assert same_bytes(getattr(sa, field), getattr(sb, field)), field
    assert int(sa.ep) == sb.ep and int(sa.max_layer) == sb.max_layer


@pytest.mark.parametrize("tier", list(TIERS))
def test_snapshot_tiers_byte_equal(monkeypatch, tier):
    set_tier(monkeypatch, tier)
    rng = np.random.default_rng(5)
    data = lattice(rng, 190, 12)
    a, b = build_pair(data[:160])
    sa, sb = a.device_snapshot(), b.device_snapshot()
    want = {"f32": torch.float32, "f16": torch.float16,
            "bf16": torch.bfloat16, "i8": torch.int8}.get(tier)
    assert (sb.nbrvec is None) == (want is None)
    assert want is None or sb.nbrvec.dtype == want
    assert (sb.qrows is not None) == (tier == "quant")
    snapshot_fields_equal(sa, sb)
    # deletes: repair re-links neighbours past the degree cap, which
    # widens deg0 and rebuilds the snapshot
    for i in range(0, 160, 7):
        a.delete_node(f"n{i}")
        b.delete_node(f"n{i}")
    sa, sb = a.device_snapshot(), b.device_snapshot()
    snapshot_fields_equal(sa, sb)
    tables = sb.nbrvec if sb.nbrvec is not None else sb.qrows
    # the delta: re-adds into freed rows, fresh rows and more deletes,
    # within the same padded shapes
    for j, i in enumerate(range(160, 190)):
        a.add_node(f"r{j}", data[i])
        b.add_node(f"r{j}", data[i])
    for i in range(1, 160, 29):
        a.delete_node(f"n{i}")
        b.delete_node(f"n{i}")
    sa, sb = a.device_snapshot(), b.device_snapshot()
    if tables is not None:  # refreshed in place, not rebuilt
        now = sb.nbrvec if sb.nbrvec is not None else sb.qrows
        assert now.data_ptr() == tables.data_ptr()
    snapshot_fields_equal(sa, sb)


def test_tier_rule_matches_jax(monkeypatch):
    """The budget picks the same tier in both packages (the JAX package's
    tile-padded reckoning), including the row-gather fallback."""
    from redis_hnsw_tpu.ops import snapshot as JSn
    from redis_hnsw_tpu_torch.ops import snapshot as TSn

    names = {jnp.float32: torch.float32, jnp.float16: torch.float16,
             jnp.int8: torch.int8, None: None}
    for budget in (9 * 2**30, 2 * 2**30, 10**9, 2 * 10**8, 1024):
        monkeypatch.setenv("REDIS_HNSW_TPU_NBRVEC_BYTES", str(budget))
        for n_pad, deg0, width in ((1_000_064, 32, 128), (1 << 21, 32, 128),
                                   (131_072, 48, 96), (4096, 16, 12)):
            j = JSn._nbrvec_dtype("euclidean", np.float32, n_pad, deg0, width)
            t = TSn._nbrvec_dtype("euclidean", n_pad, deg0, width)
            assert names[j] == t, (budget, n_pad, deg0, width)
            assert JSn._phys_block_bytes(n_pad, deg0, width, jnp.float16) \
                == TSn._phys_block_bytes(n_pad, deg0, width, 2)
    for flag, width in (("0", 960), ("1", 16), (None, 512), (None, 511)):
        if flag is None:
            monkeypatch.delenv("REDIS_HNSW_TPU_QUANT", raising=False)
        else:
            monkeypatch.setenv("REDIS_HNSW_TPU_QUANT", flag)
        assert JSn._use_quant("euclidean", width) == TSn._use_quant(
            "euclidean", width)


# -- scorers -------------------------------------------------------------------

def test_plain_block_score_matches_pallas_interpret():
    """Kernel C's plain version against the Pallas kernel in interpret
    mode and against block_neg_sq_l2, bitwise (B=16, E=2, F=8, D=16)."""
    rng = np.random.default_rng(8)
    B, E, F, Dm, N = 16, 2, 8, 16, 40
    q = lattice(rng, B, Dm)
    nbrvec = rng.integers(-4, 5, (N, F, Dm)).astype(np.float32)
    nbrsqn = np.einsum("nfd,nfd->nf", nbrvec, nbrvec).astype(np.float32)
    qn = np.einsum("bd,bd->b", q, q).astype(np.float32)
    cand = rng.integers(0, N, (B, E)).astype(np.int32)
    got = cuda_gather.fused_block_score(
        *(torch.from_numpy(x) for x in (q, qn, nbrvec, nbrsqn, cand))
    ).numpy()
    want = np.asarray(pallas_score(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(nbrvec),
        jnp.asarray(cand), interpret=True,
    ))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    mask = np.ones((B, E * F), bool)
    want = np.asarray(JD.block_neg_sq_l2(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(nbrvec),
        jnp.asarray(nbrsqn), jnp.asarray(cand), jnp.asarray(mask)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_block_and_row_scorers_bitwise(dtype):
    """block_neg_sq_l2 (masked, narrowed blocks) and frontier_neg_sq_l2
    against the JAX functions; the row form of kernel C's wrapper gives
    the row scorer's bits."""
    jdt = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
    rng = np.random.default_rng(9)
    B, E, F, Dm, N = 9, 3, 5, 24, 60
    q = lattice(rng, B, Dm)
    x = lattice(rng, N, Dm)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    adj = rng.integers(0, N, (N, F)).astype(np.int32)
    nbrvec = x[adj]
    nbrsqn = sq[adj]
    qn = np.einsum("bd,bd->b", q, q).astype(np.float32)
    cand = rng.integers(0, N, (B, E)).astype(np.int32)
    mask = rng.random((B, E * F)) < 0.8
    want = np.asarray(JD.block_neg_sq_l2(
        jnp.asarray(q), jnp.asarray(qn),
        jnp.asarray(nbrvec).astype(jdt[dtype]), jnp.asarray(nbrsqn),
        jnp.asarray(cand), jnp.asarray(mask)))
    t = {k: torch.from_numpy(v) for k, v in dict(
        q=q, qn=qn, x=x, sq=sq, nbrvec=nbrvec, nbrsqn=nbrsqn, cand=cand,
        mask=mask).items()}
    got = TD.block_neg_sq_l2(t["q"], t["qn"], t["nbrvec"].to(tdt[dtype]),
                             t["nbrsqn"], t["cand"], t["mask"]).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    ids = rng.integers(0, N, (B, 7)).astype(np.int32)
    rmask = rng.random((B, 7)) < 0.7
    want = np.asarray(JD.frontier_neg_sq_l2(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(x), jnp.asarray(sq),
        jnp.asarray(ids), jnp.asarray(rmask)))
    tids = torch.from_numpy(ids)
    got = TD.frontier_neg_sq_l2(t["q"], t["qn"], t["x"], t["sq"], tids,
                                torch.from_numpy(rmask)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    rows = cuda_gather.fused_row_score(t["q"], t["qn"], t["x"], t["sq"], tids)
    assert np.array_equal(np.where(rmask, rows.numpy(), -np.inf), got)


@pytest.mark.parametrize("form", ["block", "row"])
@pytest.mark.parametrize("dtype", ["f16", "bf16"])
def test_narrow_block_and_row_score_match_pallas_interpret(dtype, form):
    """Kernel C's plain version (block form, F = 32) and its row form
    (fused_row_score, F = 1) on f16 / bf16 tables at D = 128 against the
    Pallas kernel in interpret mode and against block_neg_sq_l2, bitwise
    on lattice data."""
    jdt = {"f16": jnp.float16, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f16": torch.float16, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(12)
    B, Dm, N = 16, 128, 40
    F, E = (32, 2) if form == "block" else (1, 8)
    q = lattice(rng, B, Dm)
    nbrvec = rng.integers(-4, 5, (N, F, Dm)).astype(np.float32)
    nbrsqn = np.einsum("nfd,nfd->nf", nbrvec, nbrvec).astype(np.float32)
    qn = np.einsum("bd,bd->b", q, q).astype(np.float32)
    cand = rng.integers(0, N, (B, E)).astype(np.int32)
    tq, tqn, tsq, tcand = (torch.from_numpy(x) for x in (q, qn, nbrsqn, cand))
    tnv = torch.from_numpy(nbrvec).to(tdt)
    if form == "block":
        got = cuda_gather.plain_block_score(tq, tqn, tnv, tsq, tcand)
        assert torch.equal(got, cuda_gather.fused_block_score(
            tq, tqn, tnv, tsq, tcand))
    else:
        got = cuda_gather.fused_row_score(tq, tqn, tnv[:, 0], tsq[:, 0],
                                          tcand)
    got = got.numpy()
    jnv = jnp.asarray(nbrvec).astype(jdt)
    want = np.asarray(pallas_score(jnp.asarray(q), jnp.asarray(qn), jnv,
                                   jnp.asarray(cand), interpret=True))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(JD.block_neg_sq_l2(
        jnp.asarray(q), jnp.asarray(qn), jnv, jnp.asarray(nbrsqn),
        jnp.asarray(cand), jnp.ones((B, E * F), bool)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_int8_scorers(rng):
    """quantize_query and the int8 tables bitwise; the int8 row and block
    scorers to within the FMA contraction XLA applies on the CPU (1e-6
    relative)."""
    from redis_hnsw_tpu.ops import snapshot as JSn
    from redis_hnsw_tpu_torch.ops import snapshot as TSn

    B, E, F, Dm, N = 12, 3, 8, 40, 50
    q = rng.standard_normal((B, Dm)).astype(np.float32)
    x = rng.standard_normal((N, Dm)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    qn = np.einsum("bd,bd->b", q, q).astype(np.float32)
    adj = rng.integers(-1, N, (N, F)).astype(np.int32)
    cand = rng.integers(0, N, (B, E)).astype(np.int32)
    ids = rng.integers(0, N, (B, F)).astype(np.int32)
    # jitted, as the JAX beam runs it: XLA turns "/ 127.0" into "* f32(1/127)"
    jq8, jqs = jax.jit(JD.quantize_query)(jnp.asarray(q))
    tq8, tqs = TD.quantize_query(torch.from_numpy(q))
    assert np.array_equal(np.asarray(jq8), tq8.numpy())
    assert np.array_equal(np.asarray(jqs), tqs.numpy())
    jnb, jmeta = JSn._build_nbrvec(jnp.asarray(x), jnp.asarray(sq),
                                   jnp.asarray(adj), dtype=jnp.int8)
    tnb, tmeta = TSn._build_nbrvec(torch.from_numpy(x), torch.from_numpy(sq),
                                   torch.from_numpy(adj), dtype=torch.int8)
    assert same_bytes(jnb, tnb) and same_bytes(jmeta, tmeta)
    jqr = JSn._quantize_rows(jnp.asarray(x), jnp.asarray(sq))
    tqr = TSn._quantize_rows(torch.from_numpy(x), torch.from_numpy(sq))
    assert same_bytes(jqr, tqr)
    mask = np.ones((B, E * F), bool)
    want = np.asarray(JD.block_int8_neg_sq_l2(
        jq8, jqs, jnp.asarray(qn), jnb, jmeta, jnp.asarray(cand),
        jnp.asarray(mask)))
    got = TD.block_int8_neg_sq_l2(tq8, tqs, torch.from_numpy(qn), tnb, tmeta,
                                  torch.from_numpy(cand),
                                  torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    want = np.asarray(JD.frontier_int8_neg_sq_l2(
        jq8, jqs, jnp.asarray(qn), jqr, jnp.asarray(ids),
        jnp.ones((B, F), bool)))
    got = TD.frontier_int8_neg_sq_l2(tq8, tqs, torch.from_numpy(qn), tqr,
                                     torch.from_numpy(ids),
                                     torch.ones((B, F), dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_int8_dots_exact_above_f32_width():
    """Above 1040 dims the int8 dots accumulate in f64: still the exact
    integer dot, as the JAX package's int32 accumulation gives."""
    rng = np.random.default_rng(3)
    q8 = rng.integers(-127, 128, (2, 1100)).astype(np.int8)
    x8 = rng.integers(-127, 128, (2, 3, 1100)).astype(np.int8)
    got = TD._int8_dots(torch.from_numpy(q8), torch.from_numpy(x8))
    want = np.einsum("bd,bfd->bf", q8.astype(np.int64), x8.astype(np.int64))
    assert np.array_equal(got.numpy(), want.astype(np.float32))


# -- descent and beam ----------------------------------------------------------

def both_inputs(pair):
    a, b, _, qs = pair
    sa, sb = a.device_snapshot(), b.device_snapshot()
    jq, tq = jnp.asarray(qs), torch.from_numpy(qs)
    jqn = JS._query_sqnorms("euclidean", jq)
    tqn = TS._query_sqnorms("euclidean", tq)
    assert np.array_equal(np.asarray(jqn), tqn.numpy())
    return sa, sb, jq, tq, jqn, tqn


def test_descent_equal(pair):
    sa, sb, jq, tq, jqn, tqn = both_inputs(pair)
    assert sb.max_layer >= 1
    ji, js = JS.greedy_descent("euclidean", jq, jqn, sa.vecs, sa.sqnorms,
                               sa.adj_up, sa.upper_of, sa.ep, sa.max_layer)
    ti, ts = TS.greedy_descent("euclidean", tq, tqn, sb.vecs, sb.sqnorms,
                               sb.adj_up, sb.upper_of, sb.ep, sb.max_layer)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(js).view(np.int32),
                          ts.numpy().view(np.int32))
    # one layer with some lanes inactive
    layer = sb.max_layer - 1
    start = np.full(len(tq), sb.ep, np.int32)
    sims0 = TS._point_sims("euclidean", tq, tqn, sb.vecs, sb.sqnorms,
                           torch.from_numpy(start))
    active = np.arange(len(tq)) % 3 != 0
    ji, js = JS.hill_climb_layer(
        "euclidean", jq, jqn, sa.vecs, sa.sqnorms, sa.adj_up[layer],
        sa.upper_of, jnp.asarray(start), jnp.asarray(sims0.numpy()),
        jnp.asarray(active))
    ti, ts = TS.hill_climb_layer(
        "euclidean", tq, tqn, sb.vecs, sb.sqnorms, sb.adj_up[layer],
        sb.upper_of, torch.from_numpy(start), sims0,
        torch.from_numpy(active))
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(js).view(np.int32),
                          ts.numpy().view(np.int32))
    assert (ti.numpy()[~active] == sb.ep).all()


@pytest.mark.parametrize(
    "expand,lazy,seeded,tier",
    [(1, False, False, "f32"), (16, False, False, "f32"),
     (16, True, False, "f32"), (1, False, True, "f32"),
     (16, False, True, "f32"), (16, True, True, "f32"),
     (16, False, True, "f16"), (4, False, False, "off")],
)
def test_beam_equal(pair, monkeypatch, expand, lazy, seeded, tier):
    """beam_search on identical snapshots and entry points: equal ids
    and bitwise-equal sims. Seeds include the entry point itself and -1
    slots (both dropped)."""
    a, b, _, qs = pair
    set_tier(monkeypatch, tier)
    if lazy:
        monkeypatch.setenv("REDIS_HNSW_TPU_LAZY_DEDUP", "1")
    a._snapshot = b._snapshot = None   # rebuild under this tier
    sa, sb, jq, tq, jqn, tqn = both_inputs(pair)
    ti, ts = TS.greedy_descent("euclidean", tq, tqn, sb.vecs, sb.sqnorms,
                               sb.adj_up, sb.upper_of, sb.ep, sb.max_layer)
    kw_j, kw_t = {}, {}
    if seeded:
        rng = np.random.default_rng(4)
        seeds = np.stack([rng.choice(300, 5, replace=False)
                          for _ in range(len(qs))]).astype(np.int32)
        seeds[:, 0] = ti.numpy()
        seeds[::4, 1] = -1
        ok = seeds >= 0
        s_sims = TS._score("euclidean", tq, tqn, sb.vecs, sb.sqnorms,
                           torch.from_numpy(seeds).clamp(min=0),
                           torch.from_numpy(ok))
        kw_j = dict(seed_ids=jnp.asarray(seeds),
                    seed_sims=jnp.asarray(s_sims.numpy()))
        kw_t = dict(seed_ids=torch.from_numpy(seeds), seed_sims=s_sims)
    ef = 24
    ji, js = JS.beam_search(
        "euclidean", jq, jqn, sa.vecs, sa.sqnorms, sa.adj0,
        jnp.asarray(ti.numpy()), jnp.asarray(ts.numpy()), ef, expand=expand,
        nbrvec=sa.nbrvec, nbrsqn=sa.nbrsqn, qrows=sa.qrows, **kw_j)
    bi, bs = TS.beam_search(
        "euclidean", tq, tqn, sb.vecs, sb.sqnorms, sb.adj0, ti, ts, ef,
        expand=expand, nbrvec=sb.nbrvec, nbrsqn=sb.nbrsqn, qrows=sb.qrows,
        **kw_t)
    assert bi.shape == (len(qs), ef)
    assert np.array_equal(np.asarray(ji), bi.numpy())
    assert np.array_equal(np.asarray(js).view(np.int32),
                          bs.numpy().view(np.int32))
    for row in bi.numpy():  # no duplicate live ids in a beam
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


def test_sort_key_pid_matches_lax_sort():
    """The packed stable sort is jax.lax.sort(num_keys=2): -0.0 equal to
    +0.0 (and kept as is), infinities, negative pids."""
    rng = np.random.default_rng(2)
    key = rng.choice(np.array([0.0, -0.0, 1.5, -2.0, np.inf, -np.inf],
                              np.float32), (6, 40))
    pid = rng.integers(-2, 5, (6, 40)).astype(np.int32)
    jk, jp = jax.lax.sort((jnp.asarray(key), jnp.asarray(pid)), dimension=1,
                          is_stable=True, num_keys=2)
    tk, tp = TS._sort_key_pid(torch.from_numpy(key), torch.from_numpy(pid))
    assert np.array_equal(np.asarray(jk).view(np.int32),
                          tk.numpy().view(np.int32))
    assert np.array_equal(np.asarray(jp), tp.numpy())
