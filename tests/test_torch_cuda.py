"""The CUDA kernels against their plain versions, on a card.

Skips without one. This file imports neither jax nor the JAX package, so
it also runs on a machine with the card and no jax, with the repository's
conftest (which imports jax) left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

chip_smoke.py covers the main path's full shapes; these are the ragged
edges and end-to-end searches (scan and graph engines, euclidean and
hamming, the one-pass tier) on the card against the same searches on the
CPU. Tolerances: bitwise on hamming words and integer-lattice data (every
score exact in f32); 1e-5 relative on Gaussian data, where the kernels'
FMA chains round otherwise than the plain versions' matmuls.
"""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu_torch.ops import (
    cuda_count,
    cuda_count_hamming,
    cuda_gather,
    cuda_scan,
    cuda_select,
)
from redis_hnsw_tpu_torch.ops import distance as TD

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def operands(rng, B, N, dim, lattice, dead, device):
    if lattice:
        q = rng.integers(-3, 4, (B, dim)).astype(np.float32)
        x = rng.integers(-3, 4, (N, dim)).astype(np.float32)
    else:
        q = rng.standard_normal((B, dim)).astype(np.float32)
        x = rng.standard_normal((N, dim)).astype(np.float32)
    live = torch.from_numpy(rng.random(N) >= dead).to(device)
    qt, xt = torch.from_numpy(q).to(device), torch.from_numpy(x).to(device)
    sq = torch.from_numpy(np.einsum("nd,nd->n", x, x)).to(device)
    return qt, xt, cuda_scan.euclid_sq_masked(sq, live), TD.sqnorms(qt)


@pytest.mark.parametrize(
    "B,N,dim,k,dead",
    [(3, 1000, 128, 10, 0.3), (70, 3000, 128, 40, 0.0), (5, 7, 24, 10, 0.3),
     (130, 2049, 33, 256, 0.5), (64, 64, 128, 1, 0.0)],
)
def test_kernels_bitwise_on_lattice(card, B, N, dim, k, dead):
    rng = np.random.default_rng(B * N)
    qt, xt, sqm, qq = operands(rng, B, N, dim, True, dead, card)
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=k)
    pi, ps = cuda_scan.plain_flat_topk(qt, xt, sqm, qq, k=k)
    assert torch.equal(ids, pi)
    assert torch.equal(sims.view(torch.int32), ps.view(torch.int32))
    t = torch.where(torch.isinf(sims[:, -1]), ps[:, 0], sims[:, -1])
    got = cuda_count.count_gt_eq(xt, sqm, qt, qq, t.contiguous())
    want = cuda_count.plain_count_gt_eq(xt, sqm, qt, qq, t.contiguous())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def split_edge(plan, dev, B, delta):
    """(N, first boundary row): a table size N that ends ``delta`` rows
    past a split boundary of a launch of kernel A, B or D (as its module's
    ``plan`` cuts the 128-row tiles), with several splits of several
    tiles each."""
    for nt in range(2, 1 << 16):
        n = nt * 128 + delta
        splits, per = plan(dev, B, n)
        if splits > 1 and per > 1 and nt % per == 0:
            return n, per * 128
    raise AssertionError("no split boundary found")


def plant_equal_rows(qt, xt, sqm, edge):
    """Query 0's copy at rows edge - 1, edge and edge + 1 (all live): its
    top 3 are those rows, in id order."""
    xt[edge - 1 : edge + 2] = qt[0]
    sqm[edge - 1 : edge + 2] = (qt[0] * qt[0]).sum()


def assert_scan_topk_bitwise(qt, xt, sqm, qq, k, planted=None):
    before = cuda_scan.flat_topk.launches
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=k)
    pi, ps = cuda_scan.plain_flat_topk(qt, xt, sqm, qq, k=k)
    torch.cuda.synchronize()
    assert cuda_scan.flat_topk.launches == before + 1
    assert torch.equal(ids, pi)
    assert torch.equal(sims.view(torch.int32), ps.view(torch.int32))
    if planted is not None:
        assert ids[0, :3].tolist() == [planted - 1, planted, planted + 1]


@pytest.mark.parametrize("B", [1, 127, 128, 129, 2049])
@pytest.mark.parametrize(
    "N", [1, 127, 128, 129, 1000, "split-1", "split+0", "split+1"])
def test_scan_topk_tile_and_split_edges(card, B, N):
    """Kernel A against its plain version, bitwise on lattice data, at the
    edges of its 128 x 128 tile (B, N at 127/128/129, B past 16 tiles)
    and of its splits (N one row short of, at and past a boundary), with
    dead rows; equal rows planted across the tile edge (rows 127-129)
    and across the first split boundary."""
    edge = 128
    if isinstance(N, str):
        N, edge = split_edge(cuda_scan.plan, card, B, int(N[len("split"):]))
    rng = np.random.default_rng(B * 7 + N)
    qt, xt, sqm, qq = operands(rng, B, N, 128, True, 0.1, card)
    planted = None
    if N > edge + 1:
        plant_equal_rows(qt, xt, sqm, edge)
        planted = edge
    assert_scan_topk_bitwise(qt, xt, sqm, qq, 10, planted)


@pytest.mark.parametrize("k", [1, 10, 40, 64, 256, 300, 1000])
@pytest.mark.parametrize("live_rows", [None, 7])
def test_scan_topk_widths(card, k, live_rows):
    """Every width, bitwise: k from 1 to past kernel A′'s 256, and fewer
    live rows than k (the (-1, -inf) tail)."""
    rng = np.random.default_rng(k)
    qt, xt, sqm, qq = operands(rng, 130, 5000, 128, True, 0.2, card)
    if live_rows is not None:
        dead = torch.ones(5000, dtype=torch.bool, device=card)
        dead[torch.from_numpy(rng.choice(5000, live_rows, replace=False))
             .to(card)] = False
        sqm[dead] = float("inf")
    plant_equal_rows(qt, xt, sqm, 128)
    assert_scan_topk_bitwise(qt, xt, sqm, qq, k)


@pytest.mark.parametrize("dim", [33, 128])
def test_scan_topk_four_byte_form(card, dim):
    """D % 4 != 0, and views 4 bytes off a 16-byte boundary, take kernel
    A's 4-byte-copy form: still bitwise equal to the plain version."""
    rng = np.random.default_rng(dim)
    qt, xt, sqm, qq = operands(rng, 130, 3000, dim, True, 0.1, card)
    q_off = torch.empty(qt.numel() + 1, device=card)[1:].view_as(qt)
    x_off = torch.empty(xt.numel() + 1, device=card)[1:].view_as(xt)
    q_off.copy_(qt)
    x_off.copy_(xt)
    assert q_off.data_ptr() % 16 and x_off.data_ptr() % 16
    plant_equal_rows(q_off, x_off, sqm, 128)
    assert_scan_topk_bitwise(q_off, x_off, sqm, qq, 40, 128)


def test_count_matches_selection_on_gaussian(card):
    """The certificate's premise on the card: with t = kernel A's k-th
    score, kernel B counts exactly k-1 rows above t and one at t."""
    rng = np.random.default_rng(1)
    qt, xt, sqm, qq = operands(rng, 64, 5000, 128, False, 0.1, card)
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=40)
    t = sims[:, 9].contiguous()
    c_gt, c_eq = cuda_count.count_gt_eq(xt, sqm, qt, qq, t)
    assert (c_gt == 9).all() and (c_eq == 1).all()


def plant_tie_class(xt, sqm, edge):
    """Row edge - 2 copied to rows edge - 1 .. edge + 1, all live: a tie
    class of 4 rows across the edge for every query."""
    xt[edge - 1 : edge + 2] = xt[edge - 2]
    sqm[edge - 2 : edge + 2] = (xt[edge - 2] * xt[edge - 2]).sum()


def count_thresholds(rng, qt, xt, sqm, qq, edge=None):
    """Per query a real score of a random live row (or, for every other
    query, of the tie class planted at ``edge``), and -inf on every 7th
    query."""
    scores = TD.pairwise_neg_sq_l2(qt, xt, sqm, qq)
    live = torch.isfinite(sqm).nonzero()[:, 0]
    if not len(live):  # a one-row table whose row is dead
        live = torch.zeros(1, dtype=torch.int64, device=qt.device)
    B = qt.shape[0]
    pick = live[torch.from_numpy(rng.integers(0, len(live), B)).to(live)]
    if edge is not None:
        pick[::2] = edge - 2
    t = scores[torch.arange(B, device=qt.device), pick]
    t[3::7] = float("-inf")
    return t.contiguous()


def assert_count_bitwise(qt, xt, sqm, qq, t):
    before = cuda_count.count_gt_eq.launches
    got = cuda_count.count_gt_eq(xt, sqm, qt, qq, t)
    want = cuda_count.plain_count_gt_eq(xt, sqm, qt, qq, t)
    torch.cuda.synchronize()
    assert cuda_count.count_gt_eq.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("B", [1, 127, 128, 129, 2049])
@pytest.mark.parametrize(
    "N", [1, 127, 128, 129, "split-1", "split+0", "split+1"])
def test_count_tile_and_split_edges(card, B, N):
    """Kernel B against its plain version, bitwise on lattice data, at the
    edges of its 128 x 128 tile (B, N at 1/127/128/129, B past 16 tiles)
    and of its splits (N one row short of, at and past a boundary), with
    dead rows and a tie class at t planted across the tile edge and
    across the first split boundary."""
    edge = 128
    if isinstance(N, str):
        N, edge = split_edge(cuda_count.plan, card, B, int(N[len("split"):]))
    rng = np.random.default_rng(B * 11 + N)
    qt, xt, sqm, qq = operands(rng, B, N, 128, True, 0.1, card)
    planted = N > edge + 1
    if planted:
        plant_tie_class(xt, sqm, edge)
    t = count_thresholds(rng, qt, xt, sqm, qq, edge if planted else None)
    _, c_eq = assert_count_bitwise(qt, xt, sqm, qq, t)
    if planted:
        assert (c_eq[::2][torch.isfinite(t[::2])] >= 4).all()


@pytest.mark.parametrize("dim,offset", [(1, 0), (33, 0), (129, 0), (33, 1),
                                        (128, 1)])
def test_count_widths_and_four_byte_form(card, dim, offset):
    """Every width D (one dim, a ragged 32-dim chunk, past 4 chunks) and
    views 4 bytes off a 16-byte boundary: D % 4 != 0 or an unaligned
    table takes kernel B's 4-byte-copy form, still bitwise equal."""
    rng = np.random.default_rng(dim * 3 + offset)
    qt, xt, sqm, qq = operands(rng, 130, 3000, dim, True, 0.1, card)
    if offset:
        q_off = torch.empty(qt.numel() + 1, device=card)[1:].view_as(qt)
        x_off = torch.empty(xt.numel() + 1, device=card)[1:].view_as(xt)
        q_off.copy_(qt)
        x_off.copy_(xt)
        assert q_off.data_ptr() % 16 and x_off.data_ptr() % 16
        qt, xt = q_off, x_off
    plant_tie_class(xt, sqm, 128)
    t = count_thresholds(rng, qt, xt, sqm, qq, 128)
    assert_count_bitwise(qt, xt, sqm, qq, t)


@pytest.mark.parametrize("N", [1000, "split+1"])
def test_count_at_neg_inf_threshold(card, N):
    """t = -inf on every query, with dead rows (sq = +inf, score -inf) and
    a ragged last tile: every live row counts as >, every dead row as ==,
    and the padding past N never counts, as in the plain version."""
    if isinstance(N, str):
        N, _ = split_edge(cuda_count.plan, card, 130, 1)
    rng = np.random.default_rng(N)
    qt, xt, sqm, qq = operands(rng, 130, N, 128, True, 0.3, card)
    t = torch.full((130,), float("-inf"), device=card)
    c_gt, c_eq = assert_count_bitwise(qt, xt, sqm, qq, t)
    live = int(torch.isfinite(sqm).sum())
    assert (c_gt == live).all() and (c_eq == N - live).all()


def test_count_small_batch_over_many_rows(card):
    """B = 16 over 400,003 rows: one query tile cut into many splits."""
    rng = np.random.default_rng(16)
    qt, xt, sqm, qq = operands(rng, 16, 400_003, 128, True, 0.1, card)
    assert cuda_count.plan(card, 16, 400_003)[0] > 100
    plant_tie_class(xt, sqm, 200_000)
    t = count_thresholds(rng, qt, xt, sqm, qq, 200_000)
    assert_count_bitwise(qt, xt, sqm, qq, t)


def test_search_on_card_matches_cpu(card, monkeypatch):
    """The same commands on the card and on the CPU give the same
    replies on lattice data, on the exact tier (k = 10 and 300) and the
    certified tier's two-pass form (its one-pass form is
    test_onepass_on_card_matches_cpu)."""
    rng = np.random.default_rng(2)
    data = rng.integers(-3, 4, (3000, 32)).astype(np.float32)
    qs = rng.integers(-3, 4, (50, 32)).astype(np.float32)
    names = [f"n{i}" for i in range(3000)]
    out = {}
    for dev in ("cuda", "cpu"):
        c = T.HNSW(device=dev)
        c.create_index("f", dim=32, kind="flat")
        c.add_batch("f", names, data)
        c.delete_batch("f", names[::5])
        idx = c.index("f")
        exact = idx.search_batch(qs, 10, reply="columnar")
        wide = idx.search_batch(qs, 300, reply="columnar")
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        monkeypatch.setenv("REDIS_HNSW_TPU_CERT_ONEPASS", "0")
        before = cuda_count.count_gt_eq.launches
        cert = idx.search_batch(qs, 10, reply="columnar")
        if dev == "cuda":
            assert cuda_count.count_gt_eq.launches == before + 1
        monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT")
        monkeypatch.delenv("REDIS_HNSW_TPU_CERT_ONEPASS")
        out[dev] = (exact, wide, cert)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


BLOCK_DTYPES = [torch.float32, torch.float16, torch.bfloat16]


def block_operands(rng, B, E, F, dim, N, lattice, dtype, device):
    if lattice:
        q = rng.integers(-4, 5, (B, dim)).astype(np.float32)
        x = rng.integers(-4, 5, (N, F, dim)).astype(np.float32)
    else:
        q = rng.standard_normal((B, dim)).astype(np.float32)
        x = rng.standard_normal((N, F, dim)).astype(np.float32)
    nbrvec = torch.from_numpy(x).to(device).to(dtype)
    nbrsqn = TD.sqnorms(nbrvec.float())
    cand = torch.from_numpy(rng.integers(0, N, (B, E)).astype(np.int32))
    qt = torch.from_numpy(q).to(device)
    return qt, TD.sqnorms(qt), nbrvec, nbrsqn, cand.to(device)


def form_of(B, E, F, dim, dtype, aligned=True):
    """The kernel form the planner picks on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elem = torch.tensor([], dtype=dtype).element_size()
    return cuda_gather.FORM_NAMES[
        cuda_gather.plan(sms, B, E, F, dim, elem, aligned).form]


@pytest.mark.parametrize("dtype", BLOCK_DTYPES)
@pytest.mark.parametrize(
    "B,E,F,dim",
    [(3, 1, 8, 24), (5, 7, 32, 128), (2, 300, 1, 33), (64, 16, 24, 40),
     (1, 9, 256, 8), (4, 3, 1, 128), (4, 3, 31, 128), (4, 3, 32, 128),
     (4, 3, 33, 128), (2, 2, 256, 128), (5, 4, 32, 1), (5, 4, 32, 24),
     (5, 4, 32, 33), (5, 4, 32, 129), (1, 16, 32, 128), (1, 1, 1, 128),
     (3, 1, 32, 128), (2, 300, 32, 64), (2, 300, 1, 128), (4, 5, 8, 128),
     (2048, 16, 32, 128), (2048, 16, 1, 128), (300, 512, 1, 128)],
)
def test_block_score_bitwise_on_lattice(card, dtype, B, E, F, dim):
    """Kernel C against its plain version: bitwise on lattice data at
    ragged shapes -- F at 1/31/32/33/256 (a block of more than 32 rows is
    several items), D at 1/24/33/129 (rows that are not whole 16-byte
    steps take the general form), B = 1, E = 1/300, the main shape and
    the row form's -- each launch counted under its form; the row form
    through fused_row_score gives the same bits."""
    rng = np.random.default_rng(B * E + F)
    ops = block_operands(rng, B, E, F, dim, 50, True, dtype, card)
    key = f"{'row' if F == 1 else 'block'}/{form_of(B, E, F, dim, dtype)}"
    before = cuda_gather.fused_block_score.launches
    before_form = cuda_gather.fused_block_score.forms[key]
    got = cuda_gather.fused_block_score(*ops)
    want = cuda_gather.plain_block_score(*ops)
    torch.cuda.synchronize()
    assert cuda_gather.fused_block_score.launches == before + 1
    assert cuda_gather.fused_block_score.forms[key] == before_form + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if F == 1:
        q, qn, nbrvec, nbrsqn, cand = ops
        rows = cuda_gather.fused_row_score(q, qn, nbrvec[:, 0],
                                           nbrsqn[:, 0], cand)
        assert torch.equal(rows.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", BLOCK_DTYPES)
def test_block_score_gaussian_and_errors(card, dtype):
    rng = np.random.default_rng(5)
    ops = block_operands(rng, 33, 16, 32, 128, 400, False, dtype, card)
    got = cuda_gather.fused_block_score(*ops)
    want = cuda_gather.plain_block_score(*ops)
    rel = (got - want).abs() / want.abs().clamp(min=1.0)
    assert rel.max().item() <= 1e-5
    q, qn, nbrvec, nbrsqn, cand = ops
    with pytest.raises(TypeError):
        cuda_gather.fused_block_score(q, qn, nbrvec.to(torch.int8), nbrsqn,
                                      cand)
    with pytest.raises(TypeError):
        cuda_gather.fused_block_score(q, qn, nbrvec, nbrsqn, cand.long())


@pytest.mark.parametrize("dtype", BLOCK_DTYPES)
@pytest.mark.parametrize("F", [1, 32])
def test_block_score_general_form_on_unaligned_operands(card, dtype, F):
    """A table or a query 4 bytes off a 16-byte boundary takes the
    general form, with the bulk forms' bits."""
    rng = np.random.default_rng(F)
    q, qn, nbrvec, nbrsqn, cand = block_operands(rng, 9, 7, F, 128, 40,
                                                 True, dtype, card)
    want = cuda_gather.fused_block_score(q, qn, nbrvec, nbrsqn, cand)
    step = 4 // nbrvec.element_size()
    buf = torch.empty(nbrvec.numel() + step, dtype=dtype, device=card)
    off = buf[step:].view(nbrvec.shape)
    off.copy_(nbrvec)
    qbuf = torch.empty(q.numel() + 1, device=card)
    qoff = qbuf[1:].view(q.shape)
    qoff.copy_(q)
    key = f"{'row' if F == 1 else 'block'}/direct"
    for args in ((q, qn, off, nbrsqn, cand), (qoff, qn, nbrvec, nbrsqn, cand)):
        assert args[2].data_ptr() % 16 or args[0].data_ptr() % 16
        before = cuda_gather.fused_block_score.forms[key]
        got = cuda_gather.fused_block_score(*args)
        torch.cuda.synchronize()
        assert cuda_gather.fused_block_score.forms[key] == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", BLOCK_DTYPES)
def test_block_score_repeated_candidates(card, dtype):
    """A candidate repeated within a lane (and across lanes) scores the
    same bits at every repeat, equal to the plain version's."""
    rng = np.random.default_rng(3)
    q, qn, nbrvec, nbrsqn, cand = block_operands(rng, 64, 16, 32, 128, 50,
                                                 True, dtype, card)
    cand[:, 3:9] = cand[:, 2:3]
    cand[5:9] = cand[4]
    got = cuda_gather.fused_block_score(q, qn, nbrvec, nbrsqn, cand)
    want = cuda_gather.plain_block_score(q, qn, nbrvec, nbrsqn, cand)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    per = got.view(64, 16, 32).view(torch.int32)
    for e in range(3, 9):
        assert torch.equal(per[:, e], per[:, 2])


@pytest.mark.parametrize("dtype", BLOCK_DTYPES)
def test_block_score_position_independent_on_gaussian(card, dtype):
    """One Gaussian row planted at several (e, f) positions of several
    blocks scores bit-identically at every copy, in every form: the block
    form, the row form over a table holding it at several rows, the
    general form (an unaligned table), and _entry_sims' narrowed rows."""
    from redis_hnsw_tpu_torch.ops import search as TS

    rng = np.random.default_rng(11)
    B, E, F, dim, N = 40, 16, 32, 128, 300
    q, qn, nbrvec, nbrsqn, cand = block_operands(rng, B, E, F, dim, N,
                                                 False, dtype, card)
    star = torch.from_numpy(rng.standard_normal(dim).astype(np.float32))
    star = star.to(card)
    narrow = star.to(dtype)
    star_sq = TD.sqnorms(narrow.float()[None])[0]
    spots = [(7, 0), (7, 31), (19, 5), (101, 17), (250, 30)]
    for blk, f in spots:
        nbrvec[blk, f] = narrow
        nbrsqn[blk, f] = star_sq
    cand[:, :5] = torch.tensor([s[0] for s in spots], dtype=torch.int32,
                               device=card)
    cand[:, 9] = 7
    got = cuda_gather.fused_block_score(q, qn, nbrvec, nbrsqn, cand)
    per = got.view(B, E, F)
    copies = [per[:, e, f] for e, (_, f) in enumerate(spots)]
    copies += [per[:, 9, 0], per[:, 9, 31]]
    # the row form: the table's rows hold the planted row at several ids
    table = nbrvec.view(N * F, dim)
    sq = nbrsqn.view(N * F)
    ids = torch.tensor([blk * F + f for blk, f in spots], dtype=torch.int32,
                       device=card).repeat(B, 1)
    rows = cuda_gather.fused_row_score(q, qn, table, sq, ids)
    copies += [rows[:, j] for j in range(len(spots))]
    # the general form: the same block table 4 bytes off its boundary
    step = 4 // nbrvec.element_size()
    buf = torch.empty(nbrvec.numel() + step, dtype=dtype, device=card)
    off = buf[step:].view(nbrvec.shape)
    off.copy_(nbrvec)
    gen = cuda_gather.fused_block_score(q, qn, off, nbrsqn, cand)
    copies += [gen.view(B, E, F)[:, 0, 0]]
    # _entry_sims narrows rows of an f32 table to the block type
    vecs = torch.zeros((N, dim), device=card)
    vecs[[3, 77]] = star
    vn = torch.zeros(N, device=card)
    vn[[3, 77]] = star_sq
    entry = TS._entry_sims(
        q, qn, vecs, vn, torch.tensor([[3, 77]], dtype=torch.int32,
                                      device=card).repeat(B, 1),
        torch.ones((B, 2), dtype=torch.bool, device=card), dtype)
    copies += [entry[:, 0], entry[:, 1]]
    torch.cuda.synchronize()
    for c in copies[1:]:
        assert torch.equal(c.view(torch.int32), copies[0].view(torch.int32))


def test_block_score_plan_matches_kernel_smem(card):
    """The planner's shared memory reckoning equals the kernel's, and
    every bulk plan fits a block's shared memory."""
    import ctypes

    from redis_hnsw_tpu_torch.utils.build import load_kernel

    fn = load_kernel("block_score").block_score_smem_bytes
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, elem in ((0, 4), (1, 2)):
        for B, E, F, dim in ((2048, 16, 32, 128), (16, 16, 32, 128),
                             (2048, 512, 1, 128), (2048, 16, 1, 128),
                             (3, 9, 256, 8), (7, 5, 64, 200)):
            p = cuda_gather.plan(sms, B, E, F, dim, elem, True)
            if p.form == cuda_gather.DIRECT:
                continue
            smem = fn(p.form, dim, dt, p.warps, p.ring)
            assert smem == cuda_gather.smem_bytes(p.form, dim, elem,
                                                  p.warps, p.ring)
            assert smem <= cuda_gather.MAX_SMEM


@pytest.mark.parametrize("tier", ["f32", "f16"])
def test_graph_on_card_matches_cpu(card, monkeypatch, tier):
    """The graph engine on the card (kernel C) gives the CPU's replies,
    byte for byte, on a lattice index."""
    from redis_hnsw_tpu_torch.ops import search as TS

    monkeypatch.setenv("REDIS_HNSW_TPU_NBRVEC_DTYPE", tier)
    rng = np.random.default_rng(7)
    data = rng.integers(-4, 5, (1200, 32)).astype(np.float32)
    qs = rng.integers(-4, 5, (70, 32)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        c = T.HNSW(device=dev)
        c.create_index("g", dim=32, m=8, ef_construction=64, seed=3)
        for i in range(1200):
            c.add_node("g", f"n{i}", data[i])
        for i in range(0, 1200, 13):
            c.delete_node("g", f"n{i}")
        before = cuda_gather.fused_block_score.launches
        out[dev] = [
            c.search_batch("g", qs, 10, engine="graph", reply="columnar",
                           **kw)
            for kw in (dict(), dict(expand=16, seeds=4),
                       dict(expand=4, ef_search=20))
        ]
        if dev == "cuda":
            assert cuda_gather.fused_block_score.launches > before
        monkeypatch.setitem(TS.SCAN_MAX_ROWS, "euclidean", 64)
        out[dev].append(c.search_batch("g", qs, 10, reply="columnar"))
        monkeypatch.undo()
        monkeypatch.setenv("REDIS_HNSW_TPU_NBRVEC_DTYPE", tier)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


@pytest.mark.parametrize("l0", ["scan", "beam"])
def test_bulk_build_on_card_matches_cpu(card, monkeypatch, l0):
    """add_batch on the card (layer-0 candidates from kernel A under
    scan-l0, from the beam on kernel C's block form under beam; upper
    beams on C's row form) builds the CPU's graph, byte for byte, on a
    lattice index; 1199 rows after the first make 256-row waves and a
    partial one."""
    monkeypatch.setenv("REDIS_HNSW_TPU_BUILD_L0", l0)
    rng = np.random.default_rng(12)
    data = rng.integers(-4, 5, (1200, 32)).astype(np.float32)
    names = [f"n{i}" for i in range(1200)]
    built = {}
    for dev in ("cuda", "cpu"):
        a0 = cuda_scan.flat_topk.launches
        c0 = cuda_gather.fused_block_score.launches
        idx = T.HNSWIndex("b", T.IndexConfig(dim=32, m=8, ef_construction=64,
                                             seed=3), device=dev)
        idx.add_batch(names, data, batch_size=256)
        built[dev] = idx
        if dev == "cuda":
            assert cuda_gather.fused_block_score.launches > c0
            assert (cuda_scan.flat_topk.launches > a0) == (l0 == "scan")
    a, b = built["cuda"], built["cpu"]
    assert a.max_layer == b.max_layer and a.enterpoint == b.enterpoint
    assert np.array_equal(a._levels[:1200], b._levels[:1200])
    for row in range(1200):
        for lc in range(int(a._levels[row]) + 1):
            assert a._nbrs(row, lc) == b._nbrs(row, lc), (row, lc)
    sa, sb = a.device_snapshot(), b.device_snapshot()
    for field in ("adj0", "adj_up", "upper_of", "vecs", "sqnorms"):
        assert torch.equal(getattr(sa, field).cpu(), getattr(sb, field))


def word_operands(rng, B, N, W, dead, device):
    q = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    x = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    x[N // 2] = q[0]  # a distance-0 row and a tie class
    x[N // 3] = q[0]
    live = torch.from_numpy(rng.random(N) >= dead).to(device)
    qt = torch.from_numpy(q.view(np.int32)).to(device)
    xt = torch.from_numpy(x.view(np.int32)).to(device)
    return qt, xt, cuda_scan.hamming_bias(live)


@pytest.mark.parametrize(
    "B,N,W,k,dead",
    [(3, 1000, 8, 10, 0.15), (70, 3001, 1, 256, 0.15), (5, 7, 3, 10, 0.3),
     (130, 2049, 25, 1, 0.5), (64, 64, 8, 40, 0.0), (9, 5000, 33, 40, 0.15)],
)
def test_hamming_kernels_bitwise(card, B, N, W, k, dead):
    """Kernel A′ against its plain version, bitwise, at ragged shapes (W
    beyond one 8-word stage)."""
    rng = np.random.default_rng(B * N + W)
    assert_hamming_bitwise(*word_operands(rng, B, N, W, dead, card), k)


def assert_hamming_bitwise(qt, xt, bias, k, planted=None):
    before = cuda_scan.flat_topk_hamming.launches
    ids, sims = cuda_scan.flat_topk_hamming(qt, xt, bias, k=k)
    pi, ps = cuda_scan.plain_flat_topk_hamming(qt, xt, bias, k=k)
    torch.cuda.synchronize()
    assert cuda_scan.flat_topk_hamming.launches == before + 1
    assert torch.equal(ids, pi)
    assert torch.equal(sims.view(torch.int32), ps.view(torch.int32))
    if planted is not None:
        want = [planted - 1, planted, planted + 1][:k]
        assert ids[0, :3].tolist() == want


def plant_word_ties(qt, xt, bias, edge):
    """Query 0's copy at rows edge - 1 .. edge + 1 (live: distance 0, its
    top 3 in id order), and row edge - 2's copy at rows edge + 2 .. edge +
    5, a tie class at every distance across the edge. word_operands'
    copies of query 0 move to distance 1 first."""
    n = xt.shape[0]
    xt[n // 2, 0] ^= 1
    xt[n // 3, 0] ^= 1
    xt[edge - 1 : edge + 2] = qt[0]
    bias[edge - 1 : edge + 2] = 0.0
    xt[edge + 2 : edge + 6] = xt[edge - 2]


def hamming_plan(dev, B, N):
    return cuda_scan.plan(dev, B, N, hamming=True)


@pytest.mark.parametrize("B", [1, 127, 128, 129, 2049])
@pytest.mark.parametrize(
    "N", [1, 127, 128, 129, 1000, "split-1", "split+0", "split+1"])
def test_hamming_tile_and_split_edges(card, B, N):
    """Kernel A′ against its plain version, bitwise, at the edges of its
    128 x 128 tile and of its splits (as its own planner cuts them), with
    dead rows, and tie classes planted across the tile edge and the first
    split boundary."""
    edge = 128
    if isinstance(N, str):
        N, edge = split_edge(hamming_plan, card, B, int(N[len("split"):]))
    rng = np.random.default_rng(B * 11 + N)
    qt, xt, bias = word_operands(rng, B, N, 8, 0.1, card)
    planted = None
    if N > edge + 5:
        plant_word_ties(qt, xt, bias, edge)
        planted = edge
    assert_hamming_bitwise(qt, xt, bias, 10, planted)


@pytest.mark.parametrize("k", [1, 10, 40, 64, 256, 257, 300, 1000])
@pytest.mark.parametrize("live_rows", [None, 7])
def test_hamming_widths(card, k, live_rows):
    """Every width through the kernel, bitwise: k from 1 to 1000, and
    fewer live rows than k (the (-1, -inf) tail)."""
    rng = np.random.default_rng(k + 1)
    qt, xt, bias = word_operands(rng, 130, 5000, 3, 0.2, card)
    if live_rows is not None:
        bias.fill_(float("-inf"))
        bias[torch.from_numpy(rng.choice(5000, live_rows, replace=False))
             .to(card)] = 0.0
    plant_word_ties(qt, xt, bias, 128)
    assert_hamming_bitwise(qt, xt, bias, k, 128)


@pytest.mark.parametrize("W", [1, 3, 8, 25, 32, 33])
@pytest.mark.parametrize("offset", [0, 1])
def test_hamming_word_widths(card, W, offset):
    """Every word width, in both copy forms: W % 4 == 0 on an aligned
    table takes the 16-byte copies; W % 4 != 0, or a table 4 bytes off a
    16-byte boundary, the 4-byte ones. W past one 8-word chunk re-expands
    the queries per chunk."""
    rng = np.random.default_rng(W * 2 + offset)
    qt, xt, bias = word_operands(rng, 130, 3000, W, 0.1, card)
    x_off = torch.empty(xt.numel() + offset, dtype=torch.int32,
                        device=card)[offset:].view_as(xt)
    x_off.copy_(xt)
    assert bool(x_off.data_ptr() % 16) == bool(offset)
    plant_word_ties(qt, x_off, bias, 128)
    assert_hamming_bitwise(qt, x_off, bias, 40, 128)


def hamming_thresholds(qt, xt, bias):
    """Per query the 10th selected score (tie classes planted there count
    as ==), and on some queries -inf (every dead row ==), a score above
    every row's, one below every row's and one between two integers."""
    _, sims = cuda_scan.flat_topk_hamming(qt, xt, bias, k=10)
    t = sims[:, 9].clone()
    t[1::7] = float("-inf")
    t[2::7] = 0.5
    t[3::7] = -32.0 * xt.shape[1] - 1
    t[4::7] = -7.5
    return t.contiguous()


def assert_count_hamming_bitwise(qt, xt, bias, t=None):
    t = hamming_thresholds(qt, xt, bias) if t is None else t
    before = cuda_count_hamming.count_hamming.launches
    got = cuda_count_hamming.count_hamming(qt, xt, bias, t)
    want = cuda_count_hamming.plain_count_hamming(qt, xt, bias, t)
    torch.cuda.synchronize()
    assert cuda_count_hamming.count_hamming.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize(
    "B,N,W,dead",
    [(3, 1000, 8, 0.15), (70, 3001, 1, 0.15), (5, 7, 3, 0.3),
     (130, 2049, 25, 0.5), (64, 64, 8, 0.0), (9, 5000, 33, 0.15),
     (1, 129, 8, 0.1), (127, 127, 8, 0.2), (129, 129, 32, 0.0),
     (2049, 3000, 8, 0.1)],
)
def test_count_hamming_bitwise(card, B, N, W, dead):
    """Kernel B′ against its plain version, bitwise, at ragged shapes (B
    and N at the tile's edges, W within and past one 8-word stage), and
    its > count against kernel A′'s selection at the 10th score."""
    rng = np.random.default_rng(B * N + W + 5)
    qt, xt, bias = word_operands(rng, B, N, W, dead, card)
    _, sims = cuda_scan.flat_topk_hamming(qt, xt, bias, k=10)
    t = sims[:, 9].contiguous()
    c_gt, _ = assert_count_hamming_bitwise(qt, xt, bias, t)
    assert torch.equal(c_gt, (sims > t[:, None]).sum(1, dtype=torch.int32))
    assert_count_hamming_bitwise(qt, xt, bias)


@pytest.mark.parametrize("B", [1, 129, 2049])
@pytest.mark.parametrize("N", ["split-1", "split+0", "split+1"])
def test_count_hamming_split_edges(card, B, N):
    """At its splits' edges as its own planner cuts them, with tie classes
    planted across the first boundary."""
    N, edge = split_edge(cuda_count_hamming.plan, card, B,
                         int(N[len("split"):]))
    rng = np.random.default_rng(B + N)
    qt, xt, bias = word_operands(rng, B, N, 8, 0.1, card)
    plant_word_ties(qt, xt, bias, edge)
    assert_count_hamming_bitwise(qt, xt, bias)


@pytest.mark.parametrize("W", [3, 8, 32])
def test_count_hamming_four_byte_form(card, W):
    """A table 4 bytes off a 16-byte boundary takes the 4-byte copies."""
    rng = np.random.default_rng(W + 77)
    qt, xt, bias = word_operands(rng, 130, 3000, W, 0.1, card)
    x_off = torch.empty(xt.numel() + 1, dtype=torch.int32,
                        device=card)[1:].view_as(xt)
    x_off.copy_(xt)
    assert x_off.data_ptr() % 16
    assert_count_hamming_bitwise(qt, x_off, bias)


@pytest.mark.parametrize("W", [1, 7, 9, 16, 17, 32, 33, 65])
@pytest.mark.parametrize("offset", [0, 1])
def test_count_hamming_word_widths(card, W, offset):
    """Widths that are not multiples of the 256-bit product (zeros past W
    in both operands), past one product (the chunk loop, stages of fewer
    rows) and past 64 words (stages of 8 rows, more shared memory), on
    aligned tables and tables 4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(W * 3 + offset + 101)
    qt, xt, bias = word_operands(rng, 130, 3000, W, 0.1, card)
    x_off = torch.empty(xt.numel() + offset, dtype=torch.int32,
                        device=card)[offset:].view_as(xt)
    x_off.copy_(xt)
    assert bool(x_off.data_ptr() % 16) == bool(offset)
    plant_word_ties(qt, x_off, bias, 128)
    assert_count_hamming_bitwise(qt, x_off, bias)


@pytest.mark.parametrize("B", [1, 129])
@pytest.mark.parametrize("N", [1, 8, 63, 64, 65, 255, 256, 257, 1000])
def test_count_hamming_stage_edges(card, B, N):
    """At the edges of a warp's 64-row stage and of a block's round of
    four stages (one a warp), with dead rows, and tie classes planted
    across the first stage edge where the table is long enough."""
    rng = np.random.default_rng(B * 7 + N)
    qt, xt, bias = word_operands(rng, B, N, 8, 0.1, card)
    if N > 70:
        plant_word_ties(qt, xt, bias, 64)
    assert_count_hamming_bitwise(qt, xt, bias)


@pytest.mark.parametrize("W", [3, 8, 17])
def test_count_hamming_special_thresholds(card, W):
    """In every 16-query tile: t = -inf, +inf, NaN, non-integers, 0, the
    scores above and below every row's, and t exactly at one of the
    query's own rows' scores (that row and its ties count as ==)."""
    rng = np.random.default_rng(W + 500)
    qt, xt, bias = word_operands(rng, 160, 2000, W, 0.2, card)
    cols = torch.from_numpy(rng.integers(0, 2000, 160)).to(card)
    t = TD.pairwise_hamming(qt, xt)[torch.arange(160, device=card), cols]
    specials = [float("-inf"), float("inf"), float("nan"), -7.5, 0.5, 0.0,
                -32.0 * W - 1, -32.0 * W]
    for i, v in enumerate(specials):
        t[i::16] = v
    assert_count_hamming_bitwise(qt, xt, bias, t.contiguous())


@pytest.mark.parametrize("dead", ["stages", "all"])
def test_count_hamming_dead_tiles(card, dead):
    """Whole stages of dead rows (the first 300: a block's first round of
    stages and part of its next), or every row dead: dead rows count as
    == against t = -inf only, never as >."""
    rng = np.random.default_rng(17 if dead == "all" else 18)
    qt, xt, bias = word_operands(rng, 130, 3000, 8, 0.0, card)
    if dead == "all":
        bias.fill_(float("-inf"))
    else:
        bias[:300] = float("-inf")
    assert_count_hamming_bitwise(qt, xt, bias)
    t = torch.full((130,), float("-inf"), device=card)
    c_gt, c_eq = assert_count_hamming_bitwise(qt, xt, bias, t)
    live = int((bias == 0).sum())
    assert (c_gt == live).all() and (c_eq == 3000 - live).all()


def test_count_hamming_filter_one_query_of_a_lane(card):
    """A lane holds queries g and g + 8 of each 16-query tile. Rows that
    pass the filter for query 0 (copies: >, and distance-1 rows at its t:
    ==) lie where nothing passes for query 8, and rows that pass for query
    8 lie elsewhere: the exact path runs for the whole tile and each query
    keeps its own counts."""
    rng = np.random.default_rng(29)
    qt, xt, bias = word_operands(rng, 16, 4096, 8, 0.0, card)
    xt[10:14] = qt[0]
    xt[20:23] = qt[0]
    xt[20:23, 0] ^= 1
    xt[270:273] = qt[8]
    xt[280:285] = qt[8]
    xt[280:285, 0] ^= 2
    _, sims = cuda_scan.flat_topk_hamming(qt, xt, bias, k=10)
    t = sims[:, 9].clone()
    t[0] = t[8] = -1.0
    c_gt, c_eq = assert_count_hamming_bitwise(qt, xt, bias, t.contiguous())
    assert (c_gt[0].item(), c_gt[8].item()) == (6, 3)  # + word_operands' 2
    assert (c_eq[0].item(), c_eq[8].item()) == (3, 5)


def test_certified_hamming_tier_on_card(card, monkeypatch):
    """The certified hamming tier on the card (kernels A′ and B′) against
    the exact tier on the card, byte for byte, on the flat index and the
    HNSW scan route: tie classes of 8 that straddle k certify, a class of
    48 at distance 0 falls back."""
    from redis_hnsw_tpu_torch.ops import scan as SC

    rng = np.random.default_rng(12)
    data = np.repeat(rng.integers(0, 2**32, (200, 8), dtype=np.uint32), 8,
                     axis=0)
    data[:48] = data[0]
    qs = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    qs[:3] = data[0]
    names = [f"n{i}" for i in range(len(data))]
    c = T.HNSW(device="cuda")
    c.create_index("f", dim=256, kind="flat", metric="hamming")
    c.add_batch("f", names, data)
    c.create_index("h", dim=256, m=8, ef_construction=48, metric="hamming")
    c.add_batch("h", names, data)
    for idx, kw in ((c.index("f"), {}), (c.index("h"), dict(engine="scan"))):
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "0")
        exact = idx.search_batch(qs, 10, reply="columnar", **kw)
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        before = dict(SC.CERT_STATS)
        b_launches = cuda_count_hamming.count_hamming.launches
        cert = idx.search_batch(qs, 10, reply="columnar", **kw)
        assert cuda_count_hamming.count_hamming.launches == b_launches + 1
        assert SC.CERT_STATS["queries"] == before["queries"] + 64
        assert SC.CERT_STATS["fallback_queries"] >= (
            before["fallback_queries"] + 3)
        assert np.array_equal(cert[0], exact[0])
        assert np.array_equal(cert[1].view(np.int32), exact[1].view(np.int32))


@pytest.mark.parametrize(
    "B,N,dim,dead",
    [(3, 1000, 128, 0.3), (70, 3001, 128, 0.0), (5, 7, 24, 0.3),
     (130, 2049, 33, 0.5), (64, 128, 128, 0.0),
     # the 128 x 128 tile's edges: B and N at 127/128/129, D not a
     # multiple of 4 or past one 32-dim stage, split boundaries +-1
     (1, 129, 1, 0.0), (127, 127, 33, 0.2), (128, 128, 129, 0.0),
     (129, 129, 128, 0.1), (128, 1000, 1, 0.0), (1, 5000, 129, 0.0),
     (129, "split-1", 128, 0.0), (129, "split+0", 33, 0.1),
     (129, "split+1", 128, 0.0)],
)
def test_select_bins_bitwise_on_lattice(card, B, N, dim, dead):
    """Kernel D against its plain version, bitwise on lattice data: bin
    maxima, their ids (ties to the lowest row, dead bins) and m2. Where
    the table has 3 bins, bin 2 is all dead (-inf at its first row id)
    and bin 1 holds query 0 twice (rows 140 and 150): the lowest id of
    query 0's copies wins and m2 equals that bin's max1, 0."""
    if isinstance(N, str):
        N = split_edge(cuda_select.plan, card, B, int(N[len("split"):]))[0]
    rng = np.random.default_rng(B + N)
    qt, xt, sqm, qq = operands(rng, B, N, dim, True, dead, card)
    if N >= 20:  # ties inside bin 0
        xt[10:20] = xt[0:10]
        sqm[10:20] = sqm[0:10]
    if N > 256:
        sqm[256:384] = float("inf")
        xt[150] = qt[0] = xt[140]
        sqm[140] = sqm[150] = (xt[140] * xt[140]).sum()
        qq = TD.sqnorms(qt)
    before = cuda_select.select_bins.launches
    got = cuda_select.select_bins(xt, sqm, qt, qq)
    want = cuda_select.plain_select_bins(xt, sqm, qt, qq)
    torch.cuda.synchronize()
    assert cuda_select.select_bins.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    if N > 256:
        sims, ids, m2 = got
        assert (sims[:, 2] == float("-inf")).all() and (ids[:, 2] == 256).all()
        same = (xt[128:256] == qt[0]).all(1) & torch.isfinite(sqm[128:256])
        assert ids[0, 1].item() == 128 + int(same.int().argmax()) <= 140
        assert sims[0, 1].item() == 0.0 and m2[0].item() == 0.0


def test_select_bins_unaligned_operands(card):
    """Views 4 bytes off a 16-byte boundary take kernel D's 4-byte-copy
    form, with D % 4 == 0: still bitwise equal to the plain version."""
    rng = np.random.default_rng(9)
    qt, xt, sqm, qq = operands(rng, 130, 3000, 128, True, 0.1, card)
    q_off = torch.empty(qt.numel() + 1, device=card)[1:].view_as(qt)
    x_off = torch.empty(xt.numel() + 1, device=card)[1:].view_as(xt)
    q_off.copy_(qt)
    x_off.copy_(xt)
    assert q_off.data_ptr() % 16 and x_off.data_ptr() % 16
    got = cuda_select.select_bins(x_off, sqm, q_off, qq)
    want = cuda_select.plain_select_bins(xt, sqm, qt, qq)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_select_bins_best_is_kernel_a_top1(card):
    """On Gaussian data D's best candidate per query is kernel A's top-1,
    score and id bit for bit: both compute one in-order FMA chain."""
    rng = np.random.default_rng(3)
    qt, xt, sqm, qq = operands(rng, 200, 20000, 128, False, 0.1, card)
    sims, ids, _ = cuda_select.select_bins(xt, sqm, qt, qq)
    best, pos = torch.sort(sims, dim=1, descending=True, stable=True)
    ti, ts = cuda_scan.flat_topk(qt, xt, sqm, qq, k=1)
    assert torch.equal(ids.gather(1, pos[:, :1]), ti)
    assert torch.equal(best[:, :1].view(torch.int32), ts.view(torch.int32))
    ps, _, _ = cuda_select.plain_select_bins(xt, sqm, qt, qq)
    rel = (sims - ps).abs() / ps.abs().clamp(min=1.0)
    assert rel[torch.isfinite(ps)].max().item() <= 1e-5
    assert torch.equal(torch.isfinite(sims), torch.isfinite(ps))


def test_select_bins_certified_top10_is_kernel_a(card):
    """On Gaussian data, on every query D certifies (m2 < the 10th
    candidate score), D's stable top-10 is kernel A's top-10, ids and
    scores bit for bit -- the one-pass certificate's premise."""
    rng = np.random.default_rng(8)
    qt, xt, sqm, qq = operands(rng, 300, 100_000, 128, False, 0.05, card)
    sims, ids, m2 = cuda_select.select_bins(xt, sqm, qt, qq)
    top, pos = torch.sort(sims, dim=1, descending=True, stable=True)
    top, top_ids = top[:, :10], ids.gather(1, pos[:, :10])
    ok = m2 < top[:, -1]
    ai, as_ = cuda_scan.flat_topk(qt, xt, sqm, qq, k=10)
    assert ok.float().mean().item() >= 0.8
    assert torch.equal(top_ids[ok], ai[ok])
    assert torch.equal(top[ok].view(torch.int32), as_[ok].view(torch.int32))


@pytest.mark.parametrize("tier", ["f32", "off"])
def test_hamming_search_on_card_matches_cpu(card, monkeypatch, tier):
    """Hamming replies on the card equal the CPU's byte for byte: the
    scan (with SCAN_CERT auto, the exact tier, and 1, the certified
    hamming tier), the graph engine (expand 1 and 16, seeds 0 and 4) and
    the flat kind with use_pallas, and at k = 300 (through kernel A′ on
    the card)."""
    monkeypatch.setenv("REDIS_HNSW_TPU_NBRVEC_DTYPE", tier)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2**32, (1500, 8), dtype=np.uint32)
    data[700:710] = data[5]
    qs = rng.integers(0, 2**32, (70, 8), dtype=np.uint32)
    qs[0] = data[5]
    out = {}
    for dev in ("cuda", "cpu"):
        c = T.HNSW(device=dev)
        c.create_index("h", dim=256, m=8, ef_construction=64, seed=3,
                       metric="hamming")
        for i in range(1500):
            c.add_node("h", f"n{i}", data[i])
        for i in range(0, 1500, 13):
            c.delete_node("h", f"n{i}")
        c.create_index("f", dim=256, kind="flat", metric="hamming")
        c.add_batch("f", [f"n{i}" for i in range(1500)], data)
        reps = [c.search_batch("h", qs, 10, engine="graph", reply="columnar",
                               **kw)
                for kw in (dict(), dict(expand=16), dict(seeds=4),
                           dict(expand=16, seeds=4))]
        reps.append(c.search_batch("h", qs, 10, reply="columnar"))
        reps.append(c.index("f").search_batch(qs, 10, reply="columnar",
                                              use_pallas=True))
        # k past 256: kernel A′ on the card, its plain version on the CPU
        reps.append(c.index("f").search_batch(qs, 300, reply="columnar"))
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        reps.append(c.search_batch("h", qs, 10, reply="columnar"))
        reps.append(c.index("f").search_batch(qs, 10, reply="columnar"))
        monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT")
        out[dev] = reps
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


def test_onepass_on_card_matches_cpu(card, monkeypatch):
    """The one-pass tier on the card (kernel D, the certified tier's
    default form) gives the CPU's replies, byte for byte, on lattice data,
    and the exact tier's."""
    rng = np.random.default_rng(4)
    data = rng.integers(-3, 4, (5000, 32)).astype(np.float32)
    qs = rng.integers(-3, 4, (60, 32)).astype(np.float32)
    names = [f"n{i}" for i in range(5000)]
    out = {}
    for dev in ("cuda", "cpu"):
        c = T.HNSW(device=dev)
        c.create_index("f", dim=32, kind="flat")
        c.add_batch("f", names, data)
        c.delete_batch("f", names[::7])
        idx = c.index("f")
        exact = idx.search_batch(qs, 5, reply="columnar")
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        before = cuda_select.select_bins.launches
        onepass = idx.search_batch(qs, 5, reply="columnar")
        if dev == "cuda":
            assert cuda_select.select_bins.launches == before + 1
        monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT")
        out[dev] = (exact, onepass)
    for a, b in (*zip(out["cuda"], out["cpu"]), out["cuda"]):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


# -- kernels A-bf16 and A-int8 (the bf16 and int8 scan tiers) ----------------

LOWP_CORES = ["bf16", "int8"]


def lowp_operands(rng, B, N, dim, core, lattice, dead, device,
                  live_rows=None, offset=0):
    """A core's operands (ops/cuda_scan.py flat_topk_bf16 / _int8) from
    seeded f32 rows: integer-lattice (|v| <= 16, exact in bf16) or
    Gaussian, with a tie class (row N // 3 copied to N // 2) and dead
    rows; the byte table's rows padded to 4 bytes (as the tier tables are
    stored) and the table ``offset`` bytes off its allocation (4 takes
    the 4-byte-copy form)."""
    from redis_hnsw_tpu_torch.ops import scan as TS

    if lattice:
        q = rng.integers(-16, 17, (B, dim)).astype(np.float32)
        x = rng.integers(-16, 17, (N, dim)).astype(np.float32)
    else:
        q = rng.standard_normal((B, dim)).astype(np.float32)
        x = rng.standard_normal((N, dim)).astype(np.float32)
    x[N // 2] = x[N // 3]
    live = rng.random(N) >= dead
    if live_rows is not None:
        live[:] = False
        live[rng.choice(N, live_rows, replace=False)] = True
    qt, xt = torch.from_numpy(q).to(device), torch.from_numpy(x).to(device)
    sq = torch.from_numpy(np.einsum("nd,nd->n", x, x)).to(device)
    sqm = cuda_scan.euclid_sq_masked(sq, torch.from_numpy(live).to(device))
    qq = TD.sqnorms(qt)
    if core == "bf16":
        table = cuda_scan.pad_lowp_rows(xt.to(torch.bfloat16))
        args = [qt.to(torch.bfloat16), table, sqm, qq]
    else:
        q8, qs = TS._to_int8(qt)
        table, ts = TS._to_int8(xt)
        table = cuda_scan.pad_lowp_rows(table)
        args = [q8, qs, table, ts, sqm, qq]
    if offset:
        nbytes = table.numel() * table.element_size()
        raw = torch.empty(nbytes + offset, dtype=torch.uint8, device=device)
        moved = raw[offset:].view(table.dtype).view(table.shape)
        moved.copy_(table)
        args[1 if core == "bf16" else 2] = moved
    return args


def run_lowp(core, args, k, plain=False, form=None):
    if core == "bf16":
        fn = (cuda_scan.plain_flat_topk_bf16 if plain
              else cuda_scan.flat_topk_bf16)
    else:
        fn = (cuda_scan.plain_flat_topk_int8 if plain
              else cuda_scan.flat_topk_int8)
    return fn(*args, k=k, **({"form": form} if form else {}))


def assert_lowp_matches(core, args, k, lattice, planted=None, form=None):
    """A core against its plain version: bitwise (ids and sims) for int8
    on any data and for bf16 on lattice data; bf16 on Gaussian data:
    every slot's sim within 1e-5 * (qq + sq) of the plain version's and
    the ids equal at every slot whose plain score lies further than the
    two rows' bands from each neighbour's in the plain ranking, the first
    row left out (rank k + 1) included. ``form``: the core forced into
    that form, its launch counted under it."""
    fn = cuda_scan.flat_topk_bf16 if core == "bf16" else \
        cuda_scan.flat_topk_int8
    before = fn.launches
    before_form = fn.forms[form]
    ids, sims = run_lowp(core, args, k, form=form)
    pi, ps = run_lowp(core, args, k + 1, plain=True)
    torch.cuda.synchronize()
    next_i, next_s = pi[:, k:], ps[:, k:]
    pi, ps = pi[:, :k], ps[:, :k]
    assert fn.launches == before + 1
    if form is not None:
        assert fn.forms[form] == before_form + 1
    fin = torch.isfinite(ps)
    assert torch.equal(fin, torch.isfinite(sims))
    if core == "int8" or lattice:
        assert torch.equal(ids, pi)
        assert torch.equal(sims.view(torch.int32), ps.view(torch.int32))
    else:
        sqm, qq = args[-2], args[-1]
        all_i = torch.cat([pi, next_i], dim=1).clamp(min=0).long()
        bands = 1e-5 * (qq[:, None] + sqm[all_i])
        bands = torch.where(torch.isfinite(bands), bands, 0.0)
        assert ((sims - ps).abs() <= bands[:, :k])[fin].all()
        scores = torch.cat([ps, next_s], dim=1)
        gap = ((scores[:, 1:] - scores[:, :-1]).abs()
               > bands[:, 1:] + bands[:, :-1])
        sep = gap[:, :k].clone()
        sep[:, 1:] &= gap[:, : k - 1]
        assert torch.equal(ids[sep & fin], pi[sep & fin])
    if planted is not None:
        assert ids[0, :3].tolist() == [planted - 1, planted, planted + 1][:k]


def plant_lowp_ties(args, core, edge):
    """Query 0's own row at rows edge - 1 .. edge + 1, live, with query
    0's sqnorm: equal scores at the top, so its top 3 are those rows in
    id order, across a tile or split edge."""
    sqm, qq, width = args[-2], args[-1], args[0].shape[1]
    if core == "bf16":
        args[1][edge - 1 : edge + 2, :width] = args[0][0]
    else:
        args[2][edge - 1 : edge + 2, :width] = args[0][0]
        args[3][edge - 1 : edge + 2] = args[1][0]
    sqm[edge - 1 : edge + 2] = qq[0]


@pytest.mark.parametrize("core", LOWP_CORES)
@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize(
    "B,N,dim,k,dead",
    [(3, 1000, 128, 10, 0.3), (70, 3000, 128, 40, 0.0), (5, 7, 24, 10, 0.3),
     (130, 2049, 33, 256, 0.5), (64, 64, 128, 1, 0.0), (1, 1, 1, 1, 0.0),
     (127, 129, 15, 10, 0.1), (129, 127, 16, 10, 0.1), (128, 128, 17, 10, 0.1),
     (9, 3001, 31, 64, 0.2), (33, 2000, 129, 80, 0.2)],
)
def test_lowp_cores_ragged(card, core, lattice, B, N, dim, k, dead):
    """Both cores against their plain versions at ragged shapes: B and N
    at 1 and about the 128-row tile, D from 1 to 129 (a 32-byte k-step,
    a 128-byte stage, widths padded to 4 bytes)."""
    rng = np.random.default_rng(B * N + dim)
    args = lowp_operands(rng, B, N, dim, core, lattice, dead, card)
    assert_lowp_matches(core, args, k, lattice)


def lowp_plan(core):
    return lambda dev, B, N: cuda_scan.lowp_plan(dev, B, N, core)


@pytest.mark.parametrize("core", LOWP_CORES)
@pytest.mark.parametrize("B", [1, 129, 2049])
@pytest.mark.parametrize("N", [127, 128, 129, "split-1", "split+0",
                               "split+1"])
def test_lowp_tile_and_split_edges(card, core, B, N):
    """Both cores bitwise at their tile's and splits' edges (as their own
    planner cuts them), on Gaussian data for int8 and lattice data for
    bf16, with query 0's copies planted across the edge."""
    edge = 128
    if isinstance(N, str):
        N, edge = split_edge(lowp_plan(core), card, B, int(N[len("split"):]))
    rng = np.random.default_rng(B * 7 + N)
    lattice = core == "bf16"
    args = lowp_operands(rng, B, N, 128, core, lattice, 0.1, card)
    planted = None
    if N > edge + 2:
        plant_lowp_ties(args, core, edge)
        planted = edge
    assert_lowp_matches(core, args, 10, lattice, planted)


@pytest.mark.parametrize("core", LOWP_CORES)
@pytest.mark.parametrize("k", [1, 10, 64, 256, 257, 1000])
@pytest.mark.parametrize("live_rows", [None, 7])
def test_lowp_widths(card, core, k, live_rows):
    """Every width: k from 1 to 1000, and fewer live rows than k."""
    rng = np.random.default_rng(k + 3)
    lattice = core == "bf16"
    args = lowp_operands(rng, 130, 5000, 24, core, lattice, 0.2, card,
                         live_rows=live_rows)
    assert_lowp_matches(core, args, k, lattice)


@pytest.mark.parametrize("core", LOWP_CORES)
@pytest.mark.parametrize("dim,offset", [(64, 0), (64, 4), (24, 0),
                                        (100, 0)])
def test_lowp_copy_forms(card, core, dim, offset):
    """The 16-byte copies (rows a multiple of 16 bytes, aligned) and the
    4-byte ones (a table 4 bytes off, or a row of 24 / 100 int8 bytes),
    and all-zero rows (int8 scale 1)."""
    rng = np.random.default_rng(dim + offset)
    lattice = core == "bf16"
    args = lowp_operands(rng, 130, 3000, dim, core, lattice, 0.1, card,
                         offset=offset)
    table = args[1] if core == "bf16" else args[2]
    table[5:9] = 0
    if core == "int8":
        args[3][5:9] = 1.0
    assert bool(table.data_ptr() % 16) == bool(offset)
    assert_lowp_matches(core, args, 40, lattice)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_tier_search_on_card_matches_cpu(card, monkeypatch, dtype):
    """REDIS_HNSW_TPU_SCAN_DTYPE on the card and on the CPU gives the same
    replies on lattice data: the HNSW scan path (scan and scan-approx),
    the flat index (bf16 copy, int8-resident at INT8_RESCORE 1 and 8) and
    flat use_pallas; the core launches on the card."""
    rng = np.random.default_rng(12)
    data = rng.integers(-16, 17, (3000, 32)).astype(np.float32)
    qs = rng.integers(-16, 17, (50, 32)).astype(np.float32)
    names = [f"n{i}" for i in range(3000)]
    monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_DTYPE", dtype)
    fn = cuda_scan.flat_topk_bf16 if dtype == "bf16" else \
        cuda_scan.flat_topk_int8
    out = {}
    for dev in ("cuda", "cpu"):
        c = T.HNSW(device=dev)
        c.create_index("g", dim=32, m=8, seed=3)
        c.add_batch("g", names, data)
        c.create_index("f", dim=32, kind="flat")
        c.add_batch("f", names, data)
        for i in "gf":
            c.delete_batch(i, names[::7])
        before = fn.launches
        got = [c.search_batch("g", qs, k=10, engine=e, reply="columnar")
               for e in ("scan", "scan-approx")]
        for mult in ("1", "8"):
            monkeypatch.setenv("REDIS_HNSW_TPU_INT8_RESCORE", mult)
            got.append(c.index("f").search_batch(qs, 10, reply="columnar"))
        got.append(c.index("f").search_batch(qs, 10, use_pallas=True,
                                             reply="columnar"))
        if dev == "cuda":
            assert fn.launches > before
        out[dev] = got
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


# -- kernel A-int8's two forms: wgmma (csrc/scan_int8.cu), general ----------

def assert_int8_form(args, k, form, planted=()):
    """Kernel A-int8 forced into ``form`` against its plain version, ids
    and sims bitwise; the launch counted under its form. ``planted``:
    (query, edge) pairs whose top 3 must be rows edge - 1 .. edge + 1 in
    id order."""
    forms = cuda_scan.flat_topk_int8.forms
    before = forms[form]
    ids, sims = cuda_scan.flat_topk_int8(*args, k=k, form=form)
    pi, ps = cuda_scan.plain_flat_topk_int8(*args, k=k)
    torch.cuda.synchronize()
    assert forms[form] == before + 1
    assert torch.equal(ids, pi)
    assert torch.equal(sims.view(torch.int32), ps.view(torch.int32))
    for q, edge in planted:
        assert ids[q, :3].tolist() == [edge - 1, edge, edge + 1][:k]


@pytest.mark.parametrize(
    "B,N,dim,k,dead,live_rows,form",
    [(64, 128, 16, 10, 0.1, None, "wgmma"),
     (128, 64, 32, 1, 0.0, None, "wgmma"),
     (65, 129, 64, 40, 0.3, None, "wgmma"),
     (129, 127, 128, 10, 0.1, None, "wgmma"),
     (64, 300, 128, 1000, 0.2, 7, "wgmma"),
     (63, 200, 128, 257, 0.2, None, "wgmma"),
     (1, 1, 16, 1, 0.0, None, "wgmma"),
     (70, 3000, 256, 64, 0.2, None, "wgmma"),    # two resident chunks
     (40, 700, 1056, 10, 0.1, None, "wgmma"),    # queries streamed
     (129, 127, 128, 10, 0.1, None, "general"),
     (64, 300, 128, 1000, 0.2, 7, "general"),
     (64, 128, 24, 10, 0.1, None, "general"),
     (65, 129, 33, 40, 0.3, None, "general"),
     (33, 2000, 129, 80, 0.2, None, "general"),
     (127, 129, 1, 1, 0.0, None, "general"),
     (128, 128, 17, 300, 0.1, 5, "general")],
)
def test_int8_forms_ragged(card, B, N, dim, k, dead, live_rows, form):
    """Both forms of kernel A-int8, each forced, bitwise against the plain
    version at ragged shapes: B and N about 64 / 128, D = 16, 32, 64, 128
    (and 256, and 1056 whose queries stream through the ring) on the
    wgmma form, rows of 24, 36, 132, 4 and 20 bytes on the general form,
    k from 1 to 1000 with fewer live rows than k."""
    rng = np.random.default_rng(B * N + dim + k)
    args = lowp_operands(rng, B, N, dim, "int8", False, dead, card,
                         live_rows=live_rows)
    assert_int8_form(args, k, form)


@pytest.mark.parametrize("dim", [24, 33, 129, 64])
def test_int8_wgmma_refuses_what_it_cannot_take(card, dim):
    """Rows that are not a multiple of 16 bytes, or a table off a 16-byte
    boundary, take the general form; forcing the wgmma form raises."""
    rng = np.random.default_rng(dim)
    args = lowp_operands(rng, 64, 500, dim, "int8", False, 0.1, card,
                         offset=4 if dim == 64 else 0)
    with pytest.raises(ValueError, match="wgmma"):
        cuda_scan.flat_topk_int8(*args, k=10, form="wgmma")
    assert_int8_form(args, 10, "general")


def plant_query_ties(args, q, edge):
    """Query q's own row at rows edge - 1 .. edge + 1, live, with its
    scale and sqnorm: its top 3 are those rows in id order."""
    q8, qs, t8, ts, sqm, qq = args
    t8[edge - 1 : edge + 2, : q8.shape[1]] = q8[q]
    ts[edge - 1 : edge + 2] = qs[q]
    sqm[edge - 1 : edge + 2] = qq[q]


@pytest.mark.parametrize("B", [129, 2049])
@pytest.mark.parametrize("k", [3, 10, 80])
def test_int8_wgmma_ties_across_every_edge(card, B, k):
    """Equal rows planted across the wgmma form's edges, for queries on
    either side of its edges: the two warpgroups' halves of a block
    (queries 63 / 64), a warp's two query rows (g and g + 8: queries 7 /
    8), a block's last and the next block's first (127 / 128); the rows
    across a 128-row tile edge and across each of its split edges as its
    own planner cuts them. Each query's ties come first in id order."""
    rng = np.random.default_rng(B + k)
    N = 40_000
    args = lowp_operands(rng, B, N, 128, "int8", False, 0.05, card)
    splits, per = cuda_scan.wgmma_plan(card, B, N, "int8")
    edges = [128, 3 * 128] + [s * per * 128 for s in range(1, splits)]
    queries = sorted({0, 7, 8, 63, 64, 127, 128, B - 1})
    planted = []
    for i, q in enumerate(queries):
        edge = edges[i % len(edges)] + (0 if i < len(edges) else 640)
        if edge + 2 < N:
            plant_query_ties(args, q, edge)
            planted.append((q, edge))
    assert splits > 1
    assert_int8_form(args, k, "wgmma", planted)
    assert_int8_form(args, k, "general", planted)


@pytest.mark.parametrize("core", ["int8", "bf16"])
@pytest.mark.parametrize("dim", [256, 512])
def test_wgmma_repeats_on_wide_rows(card, core, dim):
    """Rows of two and four 128-byte chunks (int8 D = 256, 512; bf16 D =
    256, 512: four and eight chunks), where a tile's row terms are taken
    out of the ring stage of its first chunk and that stage is released
    before the tile's last chunk is in: the wgmma form, launched 30 times
    over a full wave of blocks, equals the plain version bitwise every
    time (int8 on Gaussian data, bf16 on lattice data). A warp that read
    its stage after the release would now and then see the next tile's
    sq and tscale."""
    rng = np.random.default_rng(dim + (core == "bf16"))
    B, N, k = 2048, 30_000, 10
    args = lowp_operands(rng, B, N, dim, core, core == "bf16", 0.05, card)
    fn = cuda_scan.flat_topk_int8 if core == "int8" else \
        cuda_scan.flat_topk_bf16
    plain = cuda_scan.plain_flat_topk_int8 if core == "int8" else \
        cuda_scan.plain_flat_topk_bf16
    pi, ps = plain(*args, k=k)
    before = fn.forms["wgmma"]
    differ = 0
    for _ in range(30):
        ids, sims = fn(*args, k=k, form="wgmma")
        differ += not (torch.equal(ids, pi) and torch.equal(
            sims.view(torch.int32), ps.view(torch.int32)))
    torch.cuda.synchronize()
    assert fn.forms["wgmma"] == before + 30
    assert differ == 0


@pytest.mark.parametrize("k", [1, 10, 100])
def test_int8_wgmma_bound_on_adversarial_scales(card, k):
    """The wgmma form's dot bound on rows whose scales span six decades
    within every tile (tiny and huge rows interleaved), with tiny rows of
    both signs against each query -- so the key sits among rows of
    positive and of negative dots -- and rows of every scale next to
    them: bitwise against the plain version."""
    from redis_hnsw_tpu_torch.ops import scan as TS

    rng = np.random.default_rng(k)
    B, N, dim = 130, 6000, 128
    q = rng.standard_normal((B, dim)).astype(np.float32)
    x = rng.standard_normal((N, dim)).astype(np.float32)
    x *= (10.0 ** rng.uniform(-3, 3, N)).astype(np.float32)[:, None]
    sign = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32)
    near = rng.random(N) < 0.3  # tiny copies of a query, either sign
    src = rng.integers(0, B, N)
    x[near] = (1e-3 * sign[near, None] * q[src[near]]
               + 1e-5 * rng.standard_normal((int(near.sum()), dim)))
    x[::97] = 0.0  # all-zero rows: scale 1
    qt, xt = torch.from_numpy(q).to(card), torch.from_numpy(x).to(card)
    sq = torch.from_numpy(np.einsum("nd,nd->n", x, x)).to(card)
    live = torch.from_numpy(rng.random(N) >= 0.05).to(card)
    sqm = cuda_scan.euclid_sq_masked(sq, live)
    q8, qs = TS._to_int8(qt)
    t8, ts = TS._to_int8(xt)
    args = [q8, qs, cuda_scan.pad_lowp_rows(t8), ts, sqm, TD.sqnorms(qt)]
    assert_int8_form(args, k, "wgmma")


def test_int8_forms_counted(card):
    """flat_topk_int8.forms counts each launch by the form that served it:
    the wgmma form where the rows are a multiple of 16 bytes on 16-byte
    boundaries, the general form elsewhere and where it is forced."""
    rng = np.random.default_rng(5)
    forms = cuda_scan.flat_topk_int8.forms
    before = dict(forms)
    wide = lowp_operands(rng, 64, 400, 128, "int8", False, 0.1, card)
    narrow = lowp_operands(rng, 64, 400, 24, "int8", False, 0.1, card)
    cuda_scan.flat_topk_int8(*wide, k=10)
    cuda_scan.flat_topk_int8(*narrow, k=10)
    cuda_scan.flat_topk_int8(*wide, k=10, form="general")
    torch.cuda.synchronize()
    assert forms["wgmma"] == before.get("wgmma", 0) + 1
    assert forms["general"] == before.get("general", 0) + 2


# -- kernel A-bf16's two forms: wgmma (csrc/scan_bf16.cu), general ----------

@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize(
    "B,N,dim,k,dead,live_rows,form",
    [(64, 128, 8, 10, 0.1, None, "wgmma"),
     (128, 64, 16, 1, 0.0, None, "wgmma"),
     (65, 129, 64, 40, 0.3, None, "wgmma"),     # one 128-byte chunk
     (129, 127, 128, 10, 0.1, None, "wgmma"),   # two chunks
     (64, 300, 128, 1000, 0.2, 7, "wgmma"),
     (63, 200, 128, 257, 0.2, None, "wgmma"),
     (1, 1, 8, 1, 0.0, None, "wgmma"),
     (70, 3000, 256, 64, 0.2, None, "wgmma"),   # four resident chunks
     (40, 700, 528, 10, 0.1, None, "wgmma"),    # queries streamed
     (129, 127, 128, 10, 0.1, None, "general"),
     (64, 300, 128, 1000, 0.2, 7, "general"),
     (64, 128, 12, 10, 0.1, None, "general"),
     (65, 129, 33, 40, 0.3, None, "general"),
     (33, 2000, 100, 80, 0.2, None, "general"),
     (127, 129, 1, 1, 0.0, None, "general")],
)
def test_bf16_forms_ragged(card, lattice, B, N, dim, k, dead, live_rows,
                           form):
    """Both forms of kernel A-bf16, each forced, against the plain version
    at ragged shapes (bitwise on lattice data, within the 1e-5 (qq + sq)
    band on Gaussian data): B and N about 64 / 128, D = 8 ... 256 on the
    wgmma form (and 528, whose queries stream through the ring), rows of
    24, 68, 200 and 4 bytes on the general form, k from 1 to 1000 with
    fewer live rows than k."""
    rng = np.random.default_rng(B * N + dim + k + lattice)
    args = lowp_operands(rng, B, N, dim, "bf16", lattice, dead, card,
                         live_rows=live_rows)
    assert_lowp_matches("bf16", args, k, lattice, form=form)


@pytest.mark.parametrize("dim", [12, 33, 100, 64])
def test_bf16_wgmma_refuses_what_it_cannot_take(card, dim):
    """Rows that are not a multiple of 16 bytes, or a table off a 16-byte
    boundary, take the general form; forcing the wgmma form raises."""
    rng = np.random.default_rng(dim)
    args = lowp_operands(rng, 64, 500, dim, "bf16", True, 0.1, card,
                         offset=4 if dim == 64 else 0)
    assert cuda_scan.bf16_form_of(*args[:3]) == "general"
    with pytest.raises(ValueError, match="wgmma"):
        cuda_scan.flat_topk_bf16(*args, k=10, form="wgmma")
    assert_lowp_matches("bf16", args, 10, True, form="general")
    assert_lowp_matches("bf16", args, 10, True)


def plant_bf16_ties(args, q, edge):
    """Query q's own row at rows edge - 1 .. edge + 1, live, with its
    sqnorm: its top 3 are those rows in id order."""
    q16, t16, sqm, qq = args
    t16[edge - 1 : edge + 2, : q16.shape[1]] = q16[q]
    sqm[edge - 1 : edge + 2] = qq[q]


@pytest.mark.parametrize("B", [129, 2049])
@pytest.mark.parametrize("k", [3, 10, 80])
def test_bf16_wgmma_ties_across_every_edge(card, B, k):
    """Equal rows planted across the wgmma form's edges, for queries on
    either side of them: the two warpgroups' halves of a block (queries 63
    / 64), a warp's two query rows (g and g + 8: queries 7 / 8), a block's
    last and the next block's first (127 / 128); the rows across a
    128-row tile edge and across each of its split edges as its own
    planner cuts them. Lattice data: each query's ties come first in id
    order, and both forms equal the plain version bitwise."""
    rng = np.random.default_rng(B + k + 1)
    N = 40_000
    args = lowp_operands(rng, B, N, 128, "bf16", True, 0.05, card)
    splits, per = cuda_scan.wgmma_plan(card, B, N, "bf16")
    edges = [128, 3 * 128] + [s * per * 128 for s in range(1, splits)]
    queries = sorted({0, 7, 8, 63, 64, 127, 128, B - 1})
    planted = []
    for i, q in enumerate(queries):
        edge = edges[i % len(edges)] + (0 if i < len(edges) else 640)
        if edge + 2 < N:
            plant_bf16_ties(args, q, edge)
            planted.append((q, edge))
    assert splits > 1
    for form in cuda_scan.LOWP_FORMS:
        assert_lowp_matches("bf16", args, k, True, form=form)
        ids, _ = cuda_scan.flat_topk_bf16(*args, k=k, form=form)
        for q, edge in planted:
            assert ids[q, :3].tolist() == [edge - 1, edge, edge + 1][:k]


@pytest.mark.parametrize("k", [1, 10, 100])
def test_bf16_wgmma_sq_over_six_decades(card, k):
    """Lattice rows scaled by powers of two so that their sq spans six
    decades within every tile (tiny and huge rows interleaved), tiny
    copies of a query of either sign among them, all-zero rows, dead rows:
    every product and partial sum is exact, so both forms equal the plain
    version bitwise."""
    rng = np.random.default_rng(k + 40)
    B, N, dim = 130, 6000, 128
    q = rng.integers(-16, 17, (B, dim)).astype(np.float32)
    x = rng.integers(-16, 17, (N, dim)).astype(np.float32)
    x *= np.exp2(rng.integers(-5, 6, N)).astype(np.float32)[:, None]
    near = rng.random(N) < 0.3  # copies of a query scaled down, either sign
    sign = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32)
    x[near] = (sign[near, None] * np.exp2(-5.0).astype(np.float32)
               * q[rng.integers(0, B, N)[near]])
    x[::97] = 0.0
    qt, xt = torch.from_numpy(q).to(card), torch.from_numpy(x).to(card)
    sq = torch.from_numpy(np.einsum("nd,nd->n", x, x)).to(card)
    live = torch.from_numpy(rng.random(N) >= 0.05).to(card)
    sqm = cuda_scan.euclid_sq_masked(sq, live)
    args = [qt.to(torch.bfloat16),
            cuda_scan.pad_lowp_rows(xt.to(torch.bfloat16)), sqm,
            TD.sqnorms(qt)]
    spread = sq[sq > 0]
    assert (spread.max() / spread.min()).item() >= 1e6
    for form in cuda_scan.LOWP_FORMS:
        assert_lowp_matches("bf16", args, k, True, form=form)


def test_bf16_forms_counted(card):
    """flat_topk_bf16.forms counts each launch by the form that served it:
    the wgmma form where the rows are a multiple of 16 bytes on 16-byte
    boundaries (D = 128), the general form elsewhere (D = 100) and where
    it is forced."""
    rng = np.random.default_rng(6)
    forms = cuda_scan.flat_topk_bf16.forms
    before = dict(forms)
    wide = lowp_operands(rng, 64, 400, 128, "bf16", True, 0.1, card)
    narrow = lowp_operands(rng, 64, 400, 100, "bf16", True, 0.1, card)
    cuda_scan.flat_topk_bf16(*wide, k=10)
    cuda_scan.flat_topk_bf16(*narrow, k=10)
    cuda_scan.flat_topk_bf16(*wide, k=10, form="general")
    torch.cuda.synchronize()
    assert forms["wgmma"] == before.get("wgmma", 0) + 1
    assert forms["general"] == before.get("general", 0) + 2


# -- the pipelined serving loop (ops/scan.py drain_pipelined) ----------------


def pipeline_indexes(card):
    """A card HNSW index, a flat index, a hamming flat index and a
    3-shard index on the card, over lattice rows, each searched once so
    their snapshots and scan tables are built; and the queries."""
    from redis_hnsw_tpu_torch.parallel import ShardedHNSW

    rng = np.random.default_rng(8)
    data = rng.integers(-3, 4, (3000, 32)).astype(np.float32)
    qs = rng.integers(-3, 4, (300, 32)).astype(np.float32)
    words = rng.integers(0, 2**32, (3000, 8), dtype=np.uint32)
    hq = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    names = [f"n{i}" for i in range(3000)]
    c = T.HNSW(device="cuda")
    c.create_index("h", dim=32, m=8, ef_construction=48, seed=3)
    c.add_batch("h", names, data)
    c.create_index("f", dim=32, kind="flat")
    c.add_batch("f", names, data)
    c.create_index("w", dim=256, kind="flat", metric="hamming")
    c.add_batch("w", names, words)
    sh = ShardedHNSW("s", T.IndexConfig(dim=32, m=8, ef_construction=48,
                                        seed=3), mesh=[card] * 3)
    sh.add_batch(names, data, batch_size=1024)
    out = dict(h=c.index("h"), f=c.index("f"), w=c.index("w"), s=sh)
    for key, idx in out.items():
        idx.search_batch(hq if key == "w" else qs, 10)
    return out, qs, hq


PIPELINE_CASES = [("h", "scan", {}), ("h", "scan", {"SCAN_CERT": "1"}),
                  ("h", "scan", {"SCAN_DTYPE": "bf16"}),
                  ("h", "scan", {"SCAN_DTYPE": "int8"}),
                  ("f", None, {}), ("f", None, {"SCAN_CERT": "1"}),
                  ("f", None, {"SCAN_DTYPE": "int8"}), ("w", None, {}),
                  ("s", "scan", {}), ("s", "scan", {"SCAN_CERT": "1"})]


def test_dispatch_halves_never_wait_for_the_card(card, monkeypatch):
    """Every dispatch half queues its kernels and its reply's copy without
    one host sync: under ``torch.cuda.set_sync_debug_mode("error")`` a
    ``.cpu()``, ``.item()`` or blocking copy in a dispatch half raises.
    The finish halves run after the mode is reset and give the replies
    of the one-call forms."""
    from redis_hnsw_tpu_torch.ops import scan as TS

    idxs, qs, hq = pipeline_indexes(card)
    qd = torch.from_numpy(qs[:64]).to(card)
    hqd = torch.from_numpy(hq[:64].view(np.int32)).to(card)
    cases = []
    for env in ({}, {"SCAN_CERT": "1"}, {"SCAN_DTYPE": "bf16"},
                {"SCAN_DTYPE": "int8"}):
        cases.append(("scan_dispatch h", env, lambda: TS.scan_dispatch(
            idxs["h"], qd, 10, host_qs=qs[:64])))
    f = idxs["f"]
    for env in ({}, {"SCAN_CERT": "1"}, {"SCAN_CERT": "1",
                                         "CERT_ONEPASS": "0"}):
        cases.append(("serve_block f", env, lambda: TS.serve_block(
            *f._device()[:3], qd, k=10, n_q=64, metric="euclidean")))
    w = idxs["w"]
    cases.append(("serve_block w", {}, lambda: TS.serve_block(
        *w._device()[:3], hqd, k=10, n_q=64, metric="hamming")))

    def resident():
        q8, sqn, valid, tscale = f._device()
        return TS.serve_resident_int8(q8, sqn, valid, tscale, qd,
                                      f._vectors, qs[:64], k=10, n_q=64)

    cases.append(("serve_resident_int8 f", {"SCAN_DTYPE": "int8"}, resident))
    sh = idxs["s"]
    states = [TS._scan_state(s) for s in sh.shards]
    qds = sh._device_queries(qs)
    n_pad = max(s.device_snapshot().n_pad for s in sh.shards)
    for cert in (False, True):
        cases.append((f"sharded _scan_chunk cert={cert}", {},
                      lambda cert=cert: sh._scan_chunk(
                          states, qds, 64, 64, 10, n_pad, cert=cert)))
    for label, env, dispatch in cases:
        for key, value in env.items():
            monkeypatch.setenv(f"REDIS_HNSW_TPU_{key}", value)
        if "SCAN_DTYPE" in env:
            dispatch()  # the tier's tables built, outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fin = dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if callable(fin):
            ids, sims = fin()
            assert ids.shape[0] == 64, label
        for key in env:
            monkeypatch.delenv(f"REDIS_HNSW_TPU_{key}")


def test_pinned_pipeline_equals_serial_under_allocator_churn(card,
                                                             monkeypatch):
    """Depth 2 with pinned asynchronous copies, windows 1 and 3, gives the
    serial loop's bytes on every route; and so it does when the caching
    allocator is churned between each dispatch and its finish (large
    blocks allocated and overwritten while copies are in flight), which
    shows that a window keeps its source tensors alive until its copy
    completes."""
    from redis_hnsw_tpu_torch.ops import scan as TS
    from redis_hnsw_tpu_torch.ops import search as TSE

    idxs, qs, hq = pipeline_indexes(card)
    monkeypatch.setattr(TSE, "MAX_LANES", 64)
    real_drain = TS.drain_pipelined

    def churned(parts, dispatch, **kw):
        def churn_dispatch(*args):
            fin = dispatch(*args)
            for _ in range(3):
                junk = torch.empty(1 << 24, dtype=torch.int32, device=card)
                junk.fill_(-7)
                del junk
            return fin

        return real_drain(parts, churn_dispatch, **kw)

    for key, engine, env in PIPELINE_CASES:
        for name, value in env.items():
            monkeypatch.setenv(f"REDIS_HNSW_TPU_{name}", value)
        kw = {} if engine is None else {"engine": engine}
        q = hq if key == "w" else qs
        monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", "0")
        monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", "1")
        want = idxs[key].search_batch(q, 10, reply="columnar", **kw)
        for depth, window, drain in (("2", "1", real_drain),
                                     ("2", "3", real_drain),
                                     ("2", "1", churned),
                                     ("4", "3", churned)):
            monkeypatch.setenv("REDIS_HNSW_TPU_PIPELINE", depth)
            monkeypatch.setenv("REDIS_HNSW_TPU_FETCH_WINDOW", window)
            monkeypatch.setattr(TS, "drain_pipelined", drain)
            got = idxs[key].search_batch(q, 10, reply="columnar", **kw)
            label = f"{key} {env} depth {depth} window {window}"
            assert np.array_equal(got[0], want[0]), label
            assert np.array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32)), label
        monkeypatch.setattr(TS, "drain_pipelined", real_drain)
        for name in env:
            monkeypatch.delenv(f"REDIS_HNSW_TPU_{name}")
    assert TS._PINNED._free, "no pinned buffer was used"
