"""The CUDA kernels against their plain versions, on a card.

Skips without one. This file imports neither jax nor the JAX package, so
it also runs on a machine with the card and no jax, with the repository's
conftest (which imports jax) left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

chip_smoke.py covers the main path's full shapes; these are the ragged
edges and an end-to-end search on the card against the same search on
the CPU.
"""

import numpy as np
import pytest
import torch

import redis_hnsw_tpu_torch as T
from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan
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


def test_count_matches_selection_on_gaussian(card):
    """The certificate's premise on the card: with t = kernel A's k-th
    score, kernel B counts exactly k-1 rows above t and one at t."""
    rng = np.random.default_rng(1)
    qt, xt, sqm, qq = operands(rng, 64, 5000, 128, False, 0.1, card)
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=40)
    t = sims[:, 9].contiguous()
    c_gt, c_eq = cuda_count.count_gt_eq(xt, sqm, qt, qq, t)
    assert (c_gt == 9).all() and (c_eq == 1).all()


def test_search_on_card_matches_cpu(card, monkeypatch):
    """The same commands on the card and on the CPU give the same
    replies on lattice data, on both scan tiers."""
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
        monkeypatch.setenv("REDIS_HNSW_TPU_SCAN_CERT", "1")
        cert = idx.search_batch(qs, 10, reply="columnar")
        monkeypatch.delenv("REDIS_HNSW_TPU_SCAN_CERT")
        out[dev] = (exact, cert)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))
