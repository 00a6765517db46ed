"""The generators, the plain reference, the comparison and the bounds,
on the CPU at tiny sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_gpu import spec
from bench_gpu.gen.clustered import make_inputs
from bench_gpu.reference import compare
from bench_gpu.reference import euclidean as knn
from bench_gpu.trace import least_seconds, load_bounds

TINY_CFG = {"rows": 3000, "dim": 24, "metric": "euclidean",
            "generator": {"kind": "clustered", "centres": 16, "sigma": 0.8}}
TINY_MIX = {"request_queries": 50, "warmup_requests": 1,
            "check_per_request": 8, "load_order": "generator", "k": 10}


def test_generator_is_deterministic_in_the_seed():
    a = make_inputs(TINY_CFG, TINY_MIX, 2**31 + 17, "cpu", 6)
    b = make_inputs(TINY_CFG, TINY_MIX, 2**31 + 17, "cpu", 6)
    c = make_inputs(TINY_CFG, TINY_MIX, 2**31 + 18, "cpu", 6)
    for name in ("rows", "warm", "pool", "samples"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.rows, c.rows)
    assert not np.array_equal(a.pool, c.pool)
    assert a.rows.shape == (3000, 24) and a.rows.dtype == np.float32
    assert a.warm.shape == (50, 24) and a.pool.shape == (300, 24)
    assert a.samples.shape == (6, 8)
    for row in a.samples:  # distinct query rows of one request
        assert len(set(row)) == 8 and row.max() < 50


def test_cluster_order_groups_each_centre():
    cfg = dict(TINY_CFG, generator=dict(TINY_CFG["generator"], sigma=0.0))
    mix = dict(TINY_MIX, load_order="cluster")
    plain = make_inputs(cfg, TINY_MIX, 5, "cpu", 6).rows
    ordered = make_inputs(cfg, mix, 5, "cpu", 6).rows
    centres, which = np.unique(plain, axis=0, return_inverse=True)
    _, which_o = np.unique(ordered, axis=0, return_inverse=True)
    which, which_o = which.ravel(), which_o.ravel()
    assert np.array_equal(np.sort(which), np.sort(which_o))  # the same rows
    # each centre's rows side by side: one run of equal rows a centre
    assert np.flatnonzero(np.diff(which_o)).size + 1 == len(centres)


def _brute(rows, qs, k):
    out_i, out_d = [], []
    for q in qs.astype(np.float64):
        d = [float(((q - r.astype(np.float64)) ** 2).sum()) for r in rows]
        order = sorted(range(len(d)), key=lambda i: (d[i], i))[:k]
        out_i.append(order)
        out_d.append([d[i] for i in order])
    return np.array(out_i), np.array(out_d)


def test_reference_matches_a_brute_force_loop():
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((400, 12), generator=g)
    qs = torch.randn((30, 12), generator=g)
    idx, dist = knn.knn(rows, qs, 7, "fp64")
    bi, bd = _brute(rows.numpy(), qs.numpy(), 7)
    assert np.array_equal(idx.numpy(), bi)
    assert np.allclose(dist.numpy(), bd, rtol=1e-12, atol=1e-12)
    pd = knn.pair_dist(rows, qs, idx)
    assert np.allclose(pd.numpy(), bd, rtol=1e-13, atol=1e-13)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000, dtype=torch.float32)
    r = knn.round_tf32(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 0 < rel <= 2.0 ** -11
    # ties to even: 1 + 2^-11 (half an ulp of TF32) rounds down to 1
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11])
    assert knn.round_tf32(t).tolist() == [1.0, 1.0 + 4 * 2.0 ** -11]


def test_control_differs_from_the_reference_by_rounding():
    g = torch.Generator().manual_seed(4)
    rows = torch.randn((500, 64), generator=g)
    qs = torch.randn((40, 64), generator=g)
    _, d64 = knn.knn(rows, qs, 5, "fp64")
    _, d32 = knn.knn(rows, qs, 5, "tf32")
    rel = ((d32.double() - d64) / d64).abs().max().item()
    assert 1e-6 < rel < 1e-2


def _answers(rows, qs, k):
    idx, dist = knn.knn(torch.from_numpy(rows), torch.from_numpy(qs), k)
    return idx.numpy(), -dist.numpy(), dist.numpy()


def test_readings_of_exact_and_broken_answers():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((300, 16)).astype(np.float32)
    qs = rng.standard_normal((20, 16)).astype(np.float32)
    ids, sims, dist = _answers(rows, qs, 5)
    bad = np.zeros(20, bool)
    exact = compare.readings(ids, sims, bad, dist, knn.similarity(dist),
                             dist[:, -1], 300)
    assert exact == {"bad_answers": 0, "sim_err": 0.0, "rank_gap": 0.0}
    ok, checks = compare.judge(exact, {"bad_answers": 0, "sim_err": 1e-5,
                                       "rank_gap": 1e-5})
    assert ok and list(checks) == ["bad_answers", "sim_err", "rank_gap"]

    far = ids.copy()
    far[3, 4] = int(np.argmax(((rows - qs[3]) ** 2).sum(1)))
    d_far = knn.pair_dist(torch.from_numpy(rows), torch.from_numpy(qs),
                          torch.from_numpy(far)).numpy()
    s_far = sims.copy()
    s_far[3, 4] = -d_far[3, 4]
    r = compare.readings(far, s_far, bad, d_far, knn.similarity(d_far),
                         dist[:, -1], 300)
    assert r["rank_gap"] > 0.1 and r["bad_answers"] == 0

    off = sims.copy()
    off[5, 0] *= 1 + 1e-4
    r = compare.readings(ids, off, bad, dist, knn.similarity(dist),
                         dist[:, -1], 300)
    assert 0.9e-4 < r["sim_err"] < 1.1e-4
    assert not compare.judge(r, {"bad_answers": 0, "sim_err": 1e-5,
                                 "rank_gap": 1e-5})[0]

    broken = ids.copy()
    broken[0, 1] = broken[0, 0]          # a row named twice
    broken[1, 0] = 300                   # a row that is not there
    unsorted = sims.copy()
    unsorted[2] = unsorted[2][::-1]      # not nearest first
    flagged = bad.copy()
    flagged[4] = True                    # malformed where it was read
    r = compare.readings(broken, unsorted, flagged, dist,
                         knn.similarity(dist), dist[:, -1], 300)
    assert r["bad_answers"] == 4


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


B, N = 2048, 1_000_064


@pytest.mark.parametrize("kernel,args,kwargs,ms", [
    # fp32 matmul form at 67 TFLOP/s: 2 * 2048 * 1,000,064 * 128 operations
    ("scan_topk", (_t(B, 128), _t(N, 128), _t(N), _t(B)), {"k": 40},
     7.82569),
    ("select_bins", (_t(N, 128), _t(N), _t(B, 128), _t(B)), {}, 7.82569),
    ("count_gt_eq", (_t(N, 128), _t(N), _t(B, 128), _t(B), _t(B)), {},
     7.82569),
    # 256-bit rows as int8 products at 1,978.9 TOP/s
    ("scan_topk_hamming", (_t(B, 8, dtype=torch.int32),
                           _t(N, 8, dtype=torch.int32), _t(N)), {"k": 40},
     0.529912),
    ("count_hamming", (_t(B, 8, dtype=torch.int32),
                       _t(N, 8, dtype=torch.int32), _t(N), _t(B)), {},
     0.066239),
    ("scan_topk_bf16", (_t(B, 128, dtype=torch.bfloat16),
                        _t(N, 128, dtype=torch.bfloat16), _t(N), _t(B)),
     {"k": 10}, 0.529939),
    ("scan_topk_int8", (_t(B, 128, dtype=torch.int8), _t(B),
                        _t(N, 128, dtype=torch.int8), _t(N), _t(N), _t(B)),
     {"k": 10}, 0.264956),
    # 2048 x 16 blocks of 32 f32 rows: bytes bound at 3.35 TB/s
    ("block_score", (_t(B, 128), _t(B), _t(N, 32, 128), _t(N, 32),
                     _t(B, 16, dtype=torch.int32)), {}, 0.163119),
])
def test_bound_at_a_known_shape(kernel, args, kwargs, ms):
    bound = load_bounds()[kernel]
    got = least_seconds(bound, spec.load_peaks(), *args, **kwargs) * 1e3
    assert got == pytest.approx(ms, rel=1e-5)
