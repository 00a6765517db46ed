"""The scan kernels' plain versions against the JAX package's Pallas
kernels (run in interpret mode, as tests/test_pallas.py runs them). The
CUDA kernels against their plain versions: tests/test_torch_cuda.py.

Kernel A (ops/cuda_scan.py) ports pallas_scan.flat_topk_pallas; kernel B
(ops/cuda_count.py) ports pallas_count.count_gt_eq. On integer-lattice
data every score is exact in f32, so ids, sims and counts must agree
BYTE FOR BYTE -- including the lowest-id tie rule under heavy ties. On
Gaussian data the matmuls round differently: sims agree to 1e-4
relative and ids wherever neighbouring scores are separated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redis_hnsw_tpu.ops.pallas_count import count_gt_eq as jax_count
from redis_hnsw_tpu.ops.pallas_scan import euclid_bias, flat_topk_pallas
from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan
from redis_hnsw_tpu_torch.ops import distance as TD


def make(rng, B, N, dim, lattice, dead=0.2, dup=True):
    if lattice:
        q = rng.integers(-3, 4, (B, dim)).astype(np.float32)
        x = rng.integers(-3, 4, (N, dim)).astype(np.float32)
    else:
        q = rng.standard_normal((B, dim)).astype(np.float32)
        x = rng.standard_normal((N, dim)).astype(np.float32)
    if dup:
        x[100:120] = x[0:20]  # exact duplicates: ties at every score
    live = rng.random(N) >= dead
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    qq = np.einsum("bd,bd->b", q, q).astype(np.float32)
    return q, x, live, sq, qq


def torch_operands(q, x, live, sq, qq, device="cpu"):
    t = [torch.from_numpy(a).to(device) for a in (q, x, sq, qq)]
    sqm = cuda_scan.euclid_sq_masked(t[2], torch.from_numpy(live).to(device))
    return t[0], t[1], sqm, t[3]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("B,N,k", [(16, 700, 10), (3, 1000, 32), (9, 300, 1)])
def test_plain_topk_matches_pallas(rng, lattice, B, N, k):
    q, x, live, sq, qq = make(rng, B, N, 24, lattice)
    ji, js = flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(x),
        euclid_bias(jnp.asarray(sq), jnp.asarray(live)),
        k=k, metric="euclidean", interpret=True,
    )
    ji, js = np.asarray(ji), np.asarray(js)
    ti, ts = cuda_scan.flat_topk(*torch_operands(q, x, live, sq, qq), k=k)
    ti, ts = ti.numpy(), ts.numpy()
    if lattice:
        assert np.array_equal(ti, ji)
        assert np.array_equal(ts, js)
        return
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-4)
    gap = np.abs(np.diff(js, axis=1)) > 1e-3
    sep = np.ones_like(ji, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert np.array_equal(ti[sep], ji[sep])


def test_plain_topk_edges(rng, monkeypatch):
    """Fewer live rows than k (-1/-inf tail), an all-dead table, and
    chunk-boundary merges (CHUNK_N shrunk) keep the contract."""
    q, x, live, sq, qq = make(rng, 4, 300, 16, True, dup=False)
    live[:] = False
    live[[5, 200, 201]] = True
    ids, sims = cuda_scan.flat_topk(*torch_operands(q, x, live, sq, qq), k=6)
    assert (ids[:, 3:] == -1).all() and torch.isinf(sims[:, 3:]).all()
    assert sorted(ids[0, :3].tolist()) == [5, 200, 201]
    live[:] = False
    ids, sims = cuda_scan.flat_topk(*torch_operands(q, x, live, sq, qq), k=6)
    assert (ids == -1).all() and torch.isinf(sims).all()
    # chunked merges equal one chunk, ties included
    q, x, live, sq, qq = make(rng, 8, 1000, 16, True)
    ops = torch_operands(q, x, live, sq, qq)
    want = cuda_scan.flat_topk(*ops, k=40)
    monkeypatch.setattr(cuda_scan, "CHUNK_N", 128)
    got = cuda_scan.flat_topk(*ops, k=40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # kernel A has no width: k past N pads with (-1, -inf)
    ids, sims = cuda_scan.flat_topk(*ops, k=1001)
    assert torch.equal(ids[:, :40], want[0]) and torch.equal(sims[:, :40],
                                                               want[1])
    assert (ids[:, -1] == -1).all() and torch.isinf(sims[:, -1]).all()


@pytest.mark.parametrize(
    "B,N,want",
    [(2048, 1_000_064, (33, 237)),  # flat-sift1m: two full waves
     (16, 1_000_064, (261, 30)),    # the one-pass fallback: one wave
     (2048, 16_384, (16, 8)),       # hnsw-main's scan
     (1, 129, (2, 1)),
     (5, 0, (1, 1))],
)
def test_scan_plan(monkeypatch, B, N, want):
    """Kernel A's row splits: kernel D's wave planner over kernel A's own
    resident blocks (132 SMs x 2 here), so B = 2048 and a single query
    tile both fill whole waves."""
    monkeypatch.setattr(cuda_scan, "block_slots", lambda index: 264)
    splits, per = cuda_scan.plan(torch.device("cuda", 0), B, N)
    assert (splits, per) == want
    tiles = max(1, -(-N // 128))
    assert (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize(
    "B,N,want",
    [(2048, 1_000_064, (33, 237)),  # flat-sift1m's two-pass count
     (16, 1_000_064, (261, 30)),    # a small batch: one wave
     (2048, 16_384, (16, 8)),
     (1, 129, (2, 1)),
     (5, 0, (1, 1))],
)
def test_count_plan(monkeypatch, B, N, want):
    """Kernel B's row splits: the same wave planner over B's own resident
    blocks (132 SMs x 2 here), so B = 2048 and a single query tile both
    fill whole waves; kernel A's slots are not read."""
    from redis_hnsw_tpu_torch.ops import cuda_select

    monkeypatch.setattr(cuda_count, "block_slots", lambda index: 264)
    monkeypatch.setattr(cuda_scan, "block_slots", None)
    monkeypatch.setattr(cuda_select, "block_slots", None)
    splits, per = cuda_count.plan(torch.device("cuda", 0), B, N)
    assert (splits, per) == want
    tiles = max(1, -(-N // 128))
    assert (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize(
    "B,N,want",
    [(2048, 1_000_064, (16, 489)),  # flat-hamming-sift256: one wave
     (16, 1_000_064, (261, 30)),    # a small batch: one wave
     (2048, 16_384, (16, 8)),       # hnsw-hamming-256b's scan
     (4096, 1_000_064, (8, 977))],  # one wave, not four
)
def test_hamming_plan(monkeypatch, B, N, want):
    """Kernel A′'s row splits: the same wave planner over A′'s own
    resident blocks (132 SMs x 2 here) with A′'s fixed work a block, so a
    large batch takes one wave of long splits where tile counts alone
    would take two (B = 2048: 33 splits) or four (B = 4096), and B = 16
    still fills a wave; kernel A's slots are not read."""
    from redis_hnsw_tpu_torch.ops import cuda_select

    monkeypatch.setattr(cuda_scan, "hamming_block_slots", lambda index: 264)
    monkeypatch.setattr(cuda_scan, "block_slots", None)
    splits, per = cuda_scan.plan(torch.device("cuda", 0), B, N,
                                 hamming=True)
    assert (splits, per) == want
    tiles = -(-N // 128)
    assert (splits - 1) * per < tiles <= splits * per
    blocks = -(-B // 128) * splits
    assert 0.9 * 264 <= blocks <= 264 or N < 100_000  # one full wave
    if B >= 2048 and N > 100_000:  # tile counts alone plan more splits
        assert cuda_select.plan_splits(264, -(-B // 128), tiles) > splits


@pytest.mark.parametrize(
    "B,N,words,want",
    [(2048, 1_000_064, 8, (33, 237)),  # flat-hamming-sift256: one wave
     (16, 1_000_064, 8, (521, 15)),    # a small batch: one wave
     (2048, 16_384, 8, (32, 4)),       # hnsw-hamming-256b's rows
     (4096, 1_000_064, 8, (33, 237)),  # two full waves
     (2048, 1_000_064, 33, (99, 79)),  # wide rows: 3 blocks an SM
     (1, 129, 8, (2, 1)),
     (5, 0, 8, (1, 1))],
)
def test_count_hamming_plan(monkeypatch, B, N, words, want):
    """Kernel B′'s row splits: the wave planner over B′'s own resident
    blocks at the row width (132 SMs x 4 here up to 8 words: 128 threads,
    36,368 bytes of shared memory a block; x 3 for wider rows, whose
    queries take shared memory too), so that B = 2048 and a single query
    tile each fill one whole wave and B = 4096 two; no other kernel's
    slots are read."""
    from redis_hnsw_tpu_torch.ops import cuda_count_hamming, cuda_select

    slots = {8: 528, 33: 396}
    monkeypatch.setattr(cuda_count_hamming, "block_slots",
                        lambda index, w: slots[w])
    monkeypatch.setattr(cuda_scan, "block_slots", None)
    monkeypatch.setattr(cuda_scan, "hamming_block_slots", None)
    monkeypatch.setattr(cuda_select, "block_slots", None)
    splits, per = cuda_count_hamming.plan(torch.device("cuda", 0), B, N,
                                          words)
    assert (splits, per) == want
    tiles = max(1, -(-N // 128))
    assert (splits - 1) * per < tiles <= splits * per
    blocks = -(-B // 128) * splits
    assert blocks % slots[words] == 0 or blocks < slots[words]


@pytest.mark.parametrize(
    "row_bytes,offsets,want",
    [(128, (0, 0, 0, 0), "wgmma"),      # flat-sift1m's int8 rows
     (16, (0, 0, 0, 0), "wgmma"),
     (1056, (0, 0, 0, 0), "wgmma"),     # queries streamed
     (32768, (0, 0, 0, 0), "wgmma"),    # the widest row it takes
     (32784, (0, 0, 0, 0), "general"),  # wider: |dot| past 2^29
     (24, (0, 0, 0, 0), "general"),     # rows padded to 4 bytes only
     (36, (0, 0, 0, 0), "general"),
     (132, (0, 0, 0, 0), "general"),
     (128, (4, 0, 0, 0), "general"),    # the queries off 16 bytes
     (128, (0, 4, 0, 0), "general"),    # the table
     (128, (0, 0, 8, 0), "general"),    # sq
     (128, (0, 0, 0, 4), "general")],   # tscale
)
def test_int8_form_choice(row_bytes, offsets, want):
    """Kernel A-int8's form by row bytes and alignment: the wgmma form
    takes rows of a multiple of 16 bytes up to 32768 with every operand
    on a 16-byte boundary (a tensor map's terms), the general form the
    rest."""
    base = 1 << 20
    got = cuda_scan.int8_form(row_bytes, *(base + o for o in offsets))
    assert got == want


@pytest.mark.parametrize("B", [1, 2048, 16_384])
@pytest.mark.parametrize("N", [1, 10_000, 1_000_064, 8_388_608])
def test_int8_wave_plan(B, N):
    """The wgmma forms' planner (A-int8's and A-bf16's: 128 queries a
    block) on a card holding 132 of a form's blocks: every
    128-row range covered by exactly one split, as the kernel cuts them
    (ceil(tiles / splits) tiles each, none empty), and every query tile
    of every split in one wave; past a few tiles a split, the wave full
    to within one split's query tiles."""
    slots = 132
    splits, per = cuda_scan.wave_plan(slots, B, N)
    tiles = max(1, -(-N // 128))
    q_tiles = -(-B // 128)
    assert (splits - 1) * per < tiles <= splits * per
    assert -(-tiles // splits) == per
    assert q_tiles * splits <= slots
    if tiles >= slots:
        assert slots - q_tiles <= q_tiles * splits


def test_int8_plan_by_form(monkeypatch):
    """wgmma_plan for A-int8 reads its wgmma form's resident blocks for
    its wave plan, and the general form's planner for the general form."""
    monkeypatch.setattr(cuda_scan, "wgmma_block_slots",
                        lambda index, core: 132)
    monkeypatch.setattr(cuda_scan, "lowp_block_slots",
                        lambda index, core: 264)
    dev = torch.device("cuda", 0)
    assert cuda_scan.wgmma_plan(dev, 2048, 1_000_064, "int8") == (8, 977)
    assert cuda_scan.wgmma_plan(dev, 2048, 1_000_064, "int8",
                                "general") == \
        cuda_scan.lowp_plan(dev, 2048, 1_000_064, "int8")


def test_int8_form_keyword(rng):
    """flat_topk_int8's form= takes "wgmma" or "general" (on a CPU tensor
    both are the plain version) and rejects anything else."""
    from redis_hnsw_tpu_torch.ops import scan as TS

    q, x, live, sq, qq = make(rng, 5, 300, 16, False)
    qt, xt, sqm, qqt = torch_operands(q, x, live, sq, qq)
    q8, qs = TS._to_int8(qt)
    t8, ts = TS._to_int8(xt)
    args = (q8, qs, t8, ts, sqm, qqt)
    want = cuda_scan.plain_flat_topk_int8(*args, k=7)
    for form in (None, *cuda_scan.LOWP_FORMS):
        got = cuda_scan.flat_topk_int8(*args, k=7, form=form)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for form in ("tma", "WGMMA", ""):
        with pytest.raises(ValueError, match="form"):
            cuda_scan.flat_topk_int8(*args, k=7, form=form)


@pytest.mark.parametrize(
    "row_bytes,offsets,want",
    [(256, (0, 0, 0), "wgmma"),       # flat-sift1m's bf16 rows (D = 128)
     (16, (0, 0, 0), "wgmma"),        # D = 8
     (1024, (0, 0, 0), "wgmma"),      # the widest resident query tile
     (2112, (0, 0, 0), "wgmma"),      # D = 1056: queries streamed
     (65536, (0, 0, 0), "wgmma"),     # no widest row: its sums are f32
     (200, (0, 0, 0), "general"),     # D = 100 (phase 5b's ragged index)
     (4, (0, 0, 0), "general"),       # D = 1, padded to 4 bytes
     (36, (0, 0, 0), "general"),
     (264, (0, 0, 0), "general"),
     (256, (4, 0, 0), "general"),     # the queries off 16 bytes
     (256, (0, 8, 0), "general"),     # the table
     (256, (0, 0, 4), "general")],    # sq
)
def test_bf16_form_choice(row_bytes, offsets, want):
    """Kernel A-bf16's form by row bytes (2 D') and alignment: the wgmma
    form takes rows of a multiple of 16 bytes with the queries, the table
    and sq on a 16-byte boundary (a tensor map's terms), the general form
    the rest."""
    base = 1 << 20
    got = cuda_scan.bf16_form(row_bytes, *(base + o for o in offsets))
    assert got == want


def test_bf16_plan_by_form(monkeypatch):
    """wgmma_plan for A-bf16 reads the bf16 wgmma form's own resident
    blocks for its wave plan (not A-int8's), and the general form's
    planner for the general form."""
    monkeypatch.setattr(cuda_scan, "wgmma_block_slots",
                        lambda index, core: {"bf16": 132, "int8": 264}[core])
    monkeypatch.setattr(cuda_scan, "lowp_block_slots",
                        lambda index, core: 264)
    dev = torch.device("cuda", 0)
    assert cuda_scan.wgmma_plan(dev, 2048, 1_000_064, "bf16") == (8, 977)
    assert cuda_scan.wgmma_plan(dev, 16_384, 1_000_064, "bf16") == (1, 7813)
    assert cuda_scan.wgmma_plan(dev, 2048, 1_000_064, "bf16",
                                "general") == \
        cuda_scan.lowp_plan(dev, 2048, 1_000_064, "bf16")
    assert cuda_scan.wgmma_plan(dev, 2048, 1_000_064, "int8") == (16, 489)


@pytest.mark.parametrize("dim", [16, 100, 128])
def test_bf16_form_keyword(rng, dim):
    """flat_topk_bf16's form= takes "wgmma" or "general" (on a CPU tensor
    both are the plain version, equal to the JAX package's bf16 scores'
    top k on lattice data) and rejects anything else."""
    import jax

    q, x, live, sq, qq = make(rng, 5, 300, dim, True)
    qt, xt, sqm, qqt = torch_operands(q, x, live, sq, qq)
    args = (qt.to(torch.bfloat16),
            cuda_scan.pad_lowp_rows(xt.to(torch.bfloat16)), sqm, qqt)
    want = cuda_scan.plain_flat_topk_bf16(*args, k=7)
    dots = jnp.dot(jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16).T,
                   preferred_element_type=jnp.float32)
    scores = 2.0 * dots - jnp.asarray(qq)[:, None] - jnp.asarray(
        np.where(live, sq, np.inf).astype(np.float32))[None, :]
    jsims, jids = jax.lax.top_k(scores, 7)
    assert np.array_equal(want[0].numpy(), np.asarray(jids))
    assert np.array_equal(want[1].numpy(), np.asarray(jsims))
    for form in (None, *cuda_scan.LOWP_FORMS):
        got = cuda_scan.flat_topk_bf16(*args, k=7, form=form)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for form in ("tma", "WGMMA", "int8", ""):
        with pytest.raises(ValueError, match="form"):
            cuda_scan.flat_topk_bf16(*args, k=7, form=form)


@pytest.mark.parametrize("splits", [1, 33, 100])
def test_merge_lists_over_many_splits(rng, splits):
    """The merge of kernel A's per-split lists, more than 32 of them (one
    merge lane used to hold one list): equal to one top-k over the whole
    table, ties to the lower id, padding where splits run dry."""
    q, x, live, sq, qq = make(rng, 6, 3000, 8, True)
    ops = torch_operands(q, x, live, sq, qq)
    k = 50
    bounds = np.linspace(0, 3000, splits + 1).astype(int)
    parts = [cuda_scan.plain_flat_topk(ops[0], ops[1][lo:hi],
                                       ops[2][lo:hi], ops[3], k=k)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    part_i = torch.stack([torch.where(i >= 0, i + int(lo), i)
                          for (i, _), lo in zip(parts, bounds)])
    part_s = torch.stack([s for _, s in parts])
    got = cuda_scan.plain_merge_lists(part_s, part_i, k)
    want = cuda_scan.flat_topk(*ops, k=k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("N", [2048, 2048 - 724])
def test_plain_count_matches_pallas(rng, N):
    """Kernel B's plain version == pallas_count.count_gt_eq on lattice
    data: dead-row masking, ties (== fires), a ragged N. Thresholds are
    real scores of random live rows, plus one -inf lane, where the
    Pallas kernel's self-padding rows also count as == (the certificate
    ignores the tie count there), so that lane compares c_gt only."""
    q, x, live, sq, qq = make(rng, 16, N, 32, True)
    qt, xt, sqm, qqt = torch_operands(q, x, live, sq, qq)
    scores = TD.pairwise_neg_sq_l2(qt, xt, sqm, qqt)
    pick = torch.from_numpy(np.flatnonzero(live)[rng.integers(0, 100, 16)])
    t = scores[torch.arange(16), pick].contiguous()
    t[3] = float("-inf")
    c_gt, c_eq = cuda_count.count_gt_eq(xt, sqm, qt, qqt, t)
    j_gt, j_eq = jax_count(
        jnp.asarray(x), jnp.asarray(sqm.numpy()), jnp.asarray(q),
        jnp.asarray(qq), jnp.asarray(t.numpy()), interpret=True,
    )
    assert np.array_equal(c_gt.numpy(), np.asarray(j_gt))
    fin = np.isfinite(t.numpy())
    assert np.array_equal(c_eq.numpy()[fin], np.asarray(j_eq)[fin])
    assert (c_eq.numpy()[fin] >= 1).all()
    if N % 1024 == 0:
        assert np.array_equal(c_eq.numpy(), np.asarray(j_eq))


@pytest.mark.parametrize(
    "N,edge,neg_inf",
    [(1000, None, False),   # N not a multiple of 128
     (1153, 128, False),    # a tie class across a 128-row tile edge
     (2000, 1024, False),   # ... and across the Pallas kernel's panel edge
     (777, 128, True)],     # t = -inf everywhere, dead rows, ragged tile
)
def test_plain_count_edges_match_pallas(rng, N, edge, neg_inf):
    """Kernel B's plain version == pallas_count.count_gt_eq on lattice
    data at the kernel's edges: a ragged last tile, a tie class at t
    planted across a tile (or panel) edge, and t = -inf, where the Pallas
    kernel's self-padding rows (to its 1024-row panel) also count as ==,
    so there c_gt is compared and c_eq only against the live and dead
    rows' own count."""
    q, x, live, sq, qq = make(rng, 16, N, 32, True, dead=0.3, dup=False)
    if edge is not None:
        x[edge - 2 : edge + 2] = x[edge - 2]
        sq[edge - 2 : edge + 2] = sq[edge - 2]
        live[edge - 2 : edge + 2] = True
    qt, xt, sqm, qqt = torch_operands(q, x, live, sq, qq)
    scores = TD.pairwise_neg_sq_l2(qt, xt, sqm, qqt)
    if neg_inf:
        t = torch.full((16,), float("-inf"))
    elif edge is not None:
        t = scores[:, edge - 2].contiguous()
    else:
        pick = torch.from_numpy(np.flatnonzero(live)[rng.integers(0, 50, 16)])
        t = scores[torch.arange(16), pick].contiguous()
    c_gt, c_eq = cuda_count.count_gt_eq(xt, sqm, qt, qqt, t)
    j_gt, j_eq = jax_count(
        jnp.asarray(x), jnp.asarray(sqm.numpy()), jnp.asarray(q),
        jnp.asarray(qq), jnp.asarray(t.numpy()), interpret=True,
    )
    assert np.array_equal(c_gt.numpy(), np.asarray(j_gt))
    if neg_inf:
        assert (c_gt.numpy() == int(live.sum())).all()
        assert (c_eq.numpy() == N - int(live.sum())).all()
        assert (np.asarray(j_eq) == -N % 1024 + N - int(live.sum())).all()
        return
    assert np.array_equal(c_eq.numpy(), np.asarray(j_eq))
    if edge is not None:
        assert (c_eq.numpy() >= 4).all()


def test_plain_select_and_count_agree(rng):
    """The certificate's premise on the CPU: with t = the k-th selected
    score, the count pass counts exactly the selected rows above t, and
    all of them at t unless the tie class straddles k."""
    for lattice in (True, False):
        q, x, live, sq, qq = make(rng, 12, 900, 24, lattice)
        qt, xt, sqm, qqt = torch_operands(q, x, live, sq, qq)
        ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qqt, k=10)
        t = sims[:, -1].contiguous()
        c_gt, c_eq = cuda_count.count_gt_eq(xt, sqm, qt, qqt, t)
        assert torch.equal(c_gt, (sims > t[:, None]).sum(1, dtype=torch.int32))
        assert (c_eq >= (sims == t[:, None]).sum(1, dtype=torch.int32)).all()


@pytest.mark.parametrize(
    "B,E,F,D,elem,aligned,form",
    [(2048, 16, 32, 128, 4, True, "block"),   # hnsw-main's beam, f32
     (2048, 16, 32, 128, 2, True, "block"),   # SIFT1M-size tables, f16
     (16, 16, 32, 128, 4, True, "block"),     # a small batch
     (2, 2, 256, 128, 2, True, "block"),      # F > 32: several items
     (2048, 512, 1, 128, 4, True, "rows"),    # the off tier's frontier
     (2048, 16, 1, 128, 2, True, "rows"),     # a descent step
     (4, 3, 8, 24, 4, True, "rows"),          # small F
     (5, 4, 32, 24, 2, True, "block"),        # 48-byte rows
     (5, 4, 32, 33, 4, True, "direct"),       # 132-byte rows
     (5, 4, 32, 129, 2, True, "direct"),
     (9, 7, 32, 128, 4, False, "direct"),     # an operand off its boundary
     (2048, 16, 32, 4096, 4, True, "direct")],  # a ring too large
)
def test_block_score_plan(B, E, F, D, elem, aligned, form):
    """Kernel C's planner (ops/cuda_gather.py plan) on a 132-SM card: the
    form each shape takes; a bulk plan gives one block a SM as many warps
    as its shared memory has stages for (up to 16), each as many stages
    as then fit, and spreads the items (32 rows each) evenly over warps
    with work, on at most one block a SM."""
    from redis_hnsw_tpu_torch.ops import cuda_gather as G

    sms = 132
    p = G.plan(sms, B, E, F, D, elem, aligned)
    assert G.FORM_NAMES[p.form] == form
    rows = B * E * F
    if p.form == G.DIRECT:
        assert p.grid == max(1, min(-(-rows // G.DIRECT_THREADS), sms * 8))
        return
    st = G.stage_bytes(p.form, D, elem)
    assert st % 128 == 0 and p.ring >= 1
    assert G.smem_bytes(p.form, D, elem, p.warps, p.ring) <= G.SMEM_BUDGET
    items = B * E * -(-F // 32) if p.form == G.BLOCK else -(-rows // 32)
    busy = -(-items // p.per_warp)          # warps with work
    assert (busy - 1) * p.per_warp < items <= busy * p.per_warp
    assert p.grid <= sms and (p.grid - 1) * p.warps < busy <= p.grid * p.warps
    if busy >= sms * G.MAX_WARPS:           # a full card: every warp it fits
        assert p.warps == min(G.MAX_WARPS, (G.SMEM_BUDGET - G.HDR) // st)
