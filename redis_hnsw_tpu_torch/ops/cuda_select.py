"""Kernel D: the one-pass certified select (per-bin best rows, and m2).

Port of ``redis_hnsw_tpu/ops/pallas_select.py::select_bins`` (the Pallas
TPU kernel at pallas_select.py:166, its pallas_call at :189). The rows are
cut into bins of ``BIN_L`` = 128 consecutive rows; per query and bin it
gives the best matmul-form score

    score = (2 * q.x - |q|^2) - sq_masked[row]

and its row id (the lowest id on ties), and per query ``m2``, the largest
score that any bin holds beside its best one (a duplicate of the best at
another row counts). ``sq_masked`` is +inf on a dead row (score -inf); a
bin of dead rows gives -inf and its first row id, as ``_bin_reduce`` does.
ops/scan.py ``_certified_onepass`` builds the certified tier's one-pass
form on it: every row outside the candidates scores <= m2.

* On a CUDA tensor, :func:`select_bins` launches ``csrc/select_bins.cu``
  or raises. Its own fp32 core (128 x 128 block tiles, one per bin,
  8 x 16 register tiles, a cp.async ring; kernel A carries a copy)
  reproduces the FMA chain by which kernel A (ops/cuda_scan.py) scores,
  so candidates rank by kernel A's scores bit for bit.
  :func:`plan_splits` cuts each query tile's bins into splits so that
  the blocks fill whole waves of the card's resident slots.
* On a CPU tensor it runs :func:`plain_select_bins`: the chunked
  ``pairwise_neg_sq_l2`` scores of the plain top-k, over the same
  ``CHUNK_N`` chunks (a multiple of ``BIN_L``, so no bin straddles two), so
  on the CPU the one-pass tier ranks as the exact tier does.

The outputs cover ceil(N / BIN_L) bins; the Pallas kernel pads N to its
16,384-row panel with dead rows, whose extra bins hold -inf.

Bound on the H100: 2*B*N*D fp32 operations, like kernel B's. Times in
PERF.md (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_scan
from . import distance as D

BIN_L = 128
TILE_Q = cuda_scan.QUERY_TILE["select_bins"]  # queries a block tile
NEG_INF = float("-inf")

_P = ctypes.c_void_p
_I = ctypes.c_int

assert cuda_scan.CHUNK_N % BIN_L == 0


def plain_select_bins(vecs, sq_masked, q, qq):
    """Plain PyTorch version of :func:`select_bins`."""
    B, N = q.shape[0], vecs.shape[0]
    sims, ids = [], []
    m2 = torch.full((B,), NEG_INF, device=q.device)
    for lo in range(0, N, cuda_scan.CHUNK_N):
        hi = min(lo + cuda_scan.CHUNK_N, N)
        scores = D.pairwise_neg_sq_l2(q, vecs[lo:hi], sq_masked[lo:hi], qq)
        pad = -(hi - lo) % BIN_L
        if pad:
            scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        s3 = scores.reshape(B, -1, BIN_L)
        max1 = s3.amax(dim=2)
        col = torch.arange(BIN_L, dtype=torch.int32, device=q.device)
        idx = torch.where(s3 == max1[:, :, None], col, BIN_L).amin(dim=2)
        max2 = torch.where(col == idx[:, :, None], NEG_INF, s3).amax(dim=2)
        base = lo + BIN_L * torch.arange(
            s3.shape[1], dtype=torch.int32, device=q.device
        )
        sims.append(max1)
        ids.append(base[None, :] + idx)
        m2 = torch.maximum(m2, max2.amax(dim=1))
    if not sims:
        empty = torch.empty((B, 0), device=q.device)
        return empty, empty.to(torch.int32), m2
    return torch.cat(sims, dim=1), torch.cat(ids, dim=1), m2


@functools.lru_cache(maxsize=1024)
def plan_splits(slots: int, q_tiles: int, nbins: int,
                split_cost: int = 0) -> int:
    """Splits per query tile for ``q_tiles`` tiles over ``nbins`` bins on
    a card holding ``slots`` resident blocks: the fewest that minimise
    waves x (bins per split + ``split_cost``) (blocks of equal work finish
    together, so a wave lasts as long as its largest block), trying up to
    four waves. ``split_cost`` is a block's fixed work, in bins."""
    best, best_cost = 1, None
    for s in range(1, max(1, min(nbins, 4 * slots // q_tiles, 65535)) + 1):
        cost = -(-q_tiles * s // slots) * (-(-nbins // s) + split_cost)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _lib():
    from ..utils.build import load_kernel

    lib = load_kernel("select_bins")
    lib.select_bins_launch.restype = _I
    lib.select_bins_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                       _P, _P, _P, _P]
    lib.select_bins_slots.restype = _I
    lib.select_bins_slots.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def block_slots(device_index: int) -> int:
    """Blocks of the kernel that card ``device_index`` holds at once."""
    with torch.cuda.device(device_index):
        slots = _lib().select_bins_slots()
    if slots <= 0:
        raise RuntimeError("select_bins: cannot read the card's occupancy")
    return slots


def plan_tiles(slots_of, device, B: int, N: int,
               split_cost: int = 0) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of a split kernel (A, A′, B or
    D) over B queries and N rows: :func:`plan_splits` over the resident
    blocks ``slots_of(device index)`` of that kernel."""
    tiles = max(1, -(-N // BIN_L))
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    splits = plan_splits(slots_of(index), -(-B // TILE_Q), tiles, split_cost)
    return splits, -(-tiles // splits)


def plan(device, B: int, N: int) -> tuple[int, int]:
    """(splits, bins per split) of a launch over B queries and N rows."""
    return plan_tiles(block_slots, device, B, N)


def select_bins(vecs, sq_masked, q, qq):
    """Per-bin best (score, row id) and the second-best bound m2.

    ``vecs`` [N, D] f32, ``sq_masked`` [N] f32 (row sqnorms, +inf on dead
    rows), ``q`` [B, D] f32, ``qq`` [B] query sqnorms. Returns (sims [B,
    ceil(N/BIN_L)] f32, ids [B, ceil(N/BIN_L)] int32, m2 [B] f32). A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version.
    """
    cuda_scan.check_operands(q, vecs, sq_masked, qq, 1)
    if q.device.type == "cpu":
        return plain_select_bins(vecs, sq_masked, q, qq)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    vecs, sq_masked, q, qq = (
        t.contiguous() for t in (vecs, sq_masked, q, qq)
    )
    B, Dw = q.shape
    N = vecs.shape[0]
    dev = q.device
    nbins = -(-N // BIN_L)
    sims = torch.empty((B, nbins), dtype=torch.float32, device=dev)
    ids = torch.empty((B, nbins), dtype=torch.int32, device=dev)
    m2 = torch.full((B,), NEG_INF, dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return sims, ids, m2
    launch = _lib().select_bins_launch
    splits, _ = plan(dev, B, N)
    m2_part = torch.empty((splits, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), vecs.data_ptr(), qq.data_ptr(),
            sq_masked.data_ptr(), B, N, Dw, splits, sims.data_ptr(),
            ids.data_ptr(), m2_part.data_ptr(), m2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"select_bins kernel launch failed: CUDA error {err}")
    select_bins.launches += 1
    cuda_scan.count_lanes("select_bins", B)
    return sims, ids, m2


# Launches of the CUDA kernel in this process (see cuda_scan.flat_topk).
select_bins.launches = 0
