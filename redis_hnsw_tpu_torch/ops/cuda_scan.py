"""Kernel A: fused exact scan top-k.

Port of ``redis_hnsw_tpu/ops/pallas_scan.py::flat_topk_pallas`` (the
Pallas TPU kernel at pallas_scan.py:165, its pallas_call at :194). Per
query, the exact top-k rows of the whole table by the matmul-form score

    score = (2 * q.x - |q|^2) - sq_masked[row]

best first, ties to the lowest row id, ``-1`` / ``-inf`` in empty slots.
``sq_masked`` is the row sqnorm, ``+inf`` on a dead or padding row (score
``-inf``, never selected) -- the same encoding as the count kernel's, and
``-bias`` of the Pallas kernel's ``euclid_bias``.

* On a CUDA tensor, :func:`flat_topk` launches the hand-written CUDA
  kernel ``csrc/scan_topk.cu`` (scores through the routine of
  ``csrc/score.cuh`` that the count kernel shares, so the certificate
  sees bit-identical scores) or raises.
* On a CPU tensor it runs :func:`plain_flat_topk`: ``CHUNK_N``-row chunks
  through ``torch.mm``, a stable sort and a merge -- the kernel's
  reference in the tests.

Bound on the H100: the scoring is 2*B*N*D fp32 operations (true fp32, no
tensor cores) against (B + N)*D*4 bytes, so it is compute-bound at the
serving shapes; the kernel's design is in csrc/scan_topk.cu. Its time
beside that bound is in PERF.md, measured by chip_smoke.py.
"""

from __future__ import annotations

import ctypes

import torch

from . import distance as D

NEG_INF = float("-inf")

# Largest selection width the kernel's shared-memory lists hold: k_sel =
# 4k at the default oversample covers k <= 64 on the certified tier.
MAX_K = 256

# Rows scored per chunk by the plain version: bounds its [B, CHUNK_N]
# score tile. The plain count (ops/cuda_count.py) chunks identically, so
# on the CPU both passes of the certificate score through same-shaped
# matmuls.
CHUNK_N = 1 << 19

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_operands(queries, vecs, sq_masked, qq, k):
    """Validate the scan kernels' operands (shared with ops/cuda_count.py)."""
    if k > MAX_K:
        raise ValueError(
            f"scan top-k supports k <= {MAX_K} (the kernel's selection "
            f"width), got k={k}"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if queries.dim() != 2 or vecs.dim() != 2:
        raise ValueError("queries [B, D] and vecs [N, D] must be 2-D")
    if queries.shape[1] != vecs.shape[1]:
        raise ValueError(
            f"query width {queries.shape[1]} != table width {vecs.shape[1]}"
        )
    if tuple(sq_masked.shape) != (vecs.shape[0],):
        raise ValueError("sq_masked must be [N]")
    if tuple(qq.shape) != (queries.shape[0],):
        raise ValueError("qq must be [B]")
    for t in (queries, vecs, sq_masked, qq):
        if t.dtype != torch.float32:
            raise TypeError(f"scan top-k takes float32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError("all operands must be on one device")


def plain_flat_topk(queries, vecs, sq_masked, qq, *, k: int):
    """Plain PyTorch version of :func:`flat_topk`: chunked matmul-form
    scores (ops/distance.py pairwise_neg_sq_l2), a stable descending sort
    per chunk (row order breaks ties), and a merge with the running best
    -- earlier chunks first, so equal scores keep the lower id."""
    B = queries.shape[0]
    N = vecs.shape[0]
    dev = queries.device
    top_s = torch.full((B, 0), NEG_INF, dtype=torch.float32, device=dev)
    top_i = torch.full((B, 0), -1, dtype=torch.int32, device=dev)
    for lo in range(0, N, CHUNK_N):
        hi = min(lo + CHUNK_N, N)
        scores = D.pairwise_neg_sq_l2(
            queries, vecs[lo:hi], sq_masked[lo:hi], qq
        )
        c_s, c_pos = torch.sort(scores, dim=1, descending=True, stable=True)
        c_s = c_s[:, :k]
        c_i = (c_pos[:, :k] + lo).to(torch.int32)
        m_s = torch.cat([top_s, c_s], dim=1)
        m_i = torch.cat([top_i, c_i], dim=1)
        m_s, pos = torch.sort(m_s, dim=1, descending=True, stable=True)
        top_s = m_s[:, :k]
        top_i = torch.gather(m_i, 1, pos[:, :k])
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = torch.cat(
            [top_s, torch.full((B, pad), NEG_INF, device=dev)], dim=1
        )
        top_i = torch.cat(
            [top_i, torch.full((B, pad), -1, dtype=torch.int32,
                               device=dev)], dim=1
        )
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_i, top_s


def splits_for(device, n_q: int, n_rows: int) -> int:
    """Row splits per query tile: enough blocks for ~4 per SM, at most
    32 (one merge lane each) and at most one per 64-row tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-n_q // 64)
    want = -(-4 * sms // q_tiles)
    return max(1, min(32, want, -(-n_rows // 64)))


def _kernel():
    from ..utils.build import load_kernel

    lib = load_kernel("scan_topk")
    fn = lib.scan_topk_launch
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    return fn


def flat_topk(queries, vecs, sq_masked, qq, *, k: int):
    """Exact top-k of every query over every row of ``vecs``.

    ``queries`` [B, D] f32, ``vecs`` [N, D] f32, ``sq_masked`` [N] f32
    (row sqnorms, +inf on dead rows), ``qq`` [B] f32 (query sqnorms,
    computed once by the caller). Returns (ids [B, k] int32, sims [B, k]
    f32) in (-sim, id) order with -1/-inf padding. ``k`` <= ``MAX_K``.
    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version.
    """
    check_operands(queries, vecs, sq_masked, qq, k)
    if queries.device.type == "cpu":
        return plain_flat_topk(queries, vecs, sq_masked, qq, k=k)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    queries, vecs, sq_masked, qq = (
        t.contiguous() for t in (queries, vecs, sq_masked, qq)
    )
    B, Dw = queries.shape
    N = vecs.shape[0]
    dev = queries.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_i, out_s
    launch = _kernel()
    splits = splits_for(dev, B, N)
    part_s = torch.empty((splits, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            queries.data_ptr(), vecs.data_ptr(), qq.data_ptr(),
            sq_masked.data_ptr(), B, N, Dw, k, splits,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_topk kernel launch failed: CUDA error {err}")
    flat_topk.launches += 1
    return out_i, out_s


# Launches of the CUDA kernel in this process (plain-version calls on the
# CPU do not count). chip_smoke.py resets and reads it around the main path.
flat_topk.launches = 0


def euclid_sq_masked(sqnorms, valid):
    """Row sqnorms with +inf on dead rows: the kernels' row operand (the
    Pallas kernel's ``euclid_bias`` is its negation)."""
    return torch.where(
        valid, sqnorms, torch.full_like(sqnorms, float("inf"))
    )
