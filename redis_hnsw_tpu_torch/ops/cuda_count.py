"""Kernel B: per-query threshold counts for the scan certificate.

Port of ``redis_hnsw_tpu/ops/pallas_count.py::count_gt_eq`` (the Pallas
TPU kernel at pallas_count.py:78, its pallas_call at :103). For each query
b, the counts of rows whose matmul-form score

    score = (2 * q.x - |q|^2) - sq_masked[row]

is ``> t[b]`` and ``== t[b]``. Dead rows carry ``sq_masked = +inf`` and
score ``-inf``.

Soundness: the certificate (ops/scan.py) compares these counts with the
counts over the selected scores, so the recomputed scores must be
bit-identical to the selection pass's. On CUDA both kernels compute the
chain of ``csrc/score.cuh`` (a sequential fp32 FMA chain over the dims,
then explicitly rounded subtractions) -- this kernel through that routine,
kernel A through its own 128 x 128 core -- so they are by arithmetic; on
the CPU both plain versions score through
ops/distance.py ``pairwise_neg_sq_l2`` over the same ``CHUNK_N`` chunks.
The every-256th-batch audit in ops/scan.py certified_finish still turns
any residual drift into a counted, repaired signal.

* On a CUDA tensor, :func:`count_gt_eq` launches ``csrc/count_gt_eq.cu``
  or raises.
* On a CPU tensor it runs :func:`plain_count_gt_eq` (chunked masked sums),
  the kernel's reference in the tests.

Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes --
compute-bound, like the selection. Times in PERF.md (chip_smoke.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_scan
from . import distance as D

_P = ctypes.c_void_p
_I = ctypes.c_int


def plain_count_gt_eq(vecs, sq_masked, q, qq, t):
    """Plain PyTorch version of :func:`count_gt_eq`."""
    B, N = q.shape[0], vecs.shape[0]
    c_gt = torch.zeros(B, dtype=torch.int32, device=q.device)
    c_eq = torch.zeros(B, dtype=torch.int32, device=q.device)
    for lo in range(0, N, cuda_scan.CHUNK_N):
        hi = min(lo + cuda_scan.CHUNK_N, N)
        scores = D.pairwise_neg_sq_l2(q, vecs[lo:hi], sq_masked[lo:hi], qq)
        c_gt += (scores > t[:, None]).sum(dim=1, dtype=torch.int32)
        c_eq += (scores == t[:, None]).sum(dim=1, dtype=torch.int32)
    return c_gt, c_eq


def _kernel():
    from ..utils.build import load_kernel

    lib = load_kernel("count_gt_eq")
    fn = lib.count_gt_eq_launch
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    return fn


def count_gt_eq(vecs, sq_masked, q, qq, t):
    """Per-query counts of rows scoring (>, ==) ``t`` in matmul form.

    ``vecs`` [N, D] f32; ``sq_masked`` [N] f32 row sqnorms with +inf on
    dead rows; ``q`` [B, D] f32; ``qq`` [B] query sqnorms; ``t`` [B]
    thresholds. Returns (c_gt, c_eq) [B] int32. A CUDA tensor launches
    the kernel; a CPU tensor takes the plain version.
    """
    if tuple(t.shape) != (q.shape[0],) or t.dtype != torch.float32:
        raise ValueError("t must be float32 [B]")
    cuda_scan.check_operands(q, vecs, sq_masked, qq, 1)
    if t.device != q.device:
        raise ValueError("all operands must be on one device")
    if q.device.type == "cpu":
        return plain_count_gt_eq(vecs, sq_masked, q, qq, t)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    vecs, sq_masked, q, qq, t = (
        x.contiguous() for x in (vecs, sq_masked, q, qq, t)
    )
    B, Dw = q.shape
    N = vecs.shape[0]
    dev = q.device
    c_gt = torch.zeros(B, dtype=torch.int32, device=dev)
    c_eq = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return c_gt, c_eq
    launch = _kernel()
    splits = cuda_scan.splits_for(dev, B, N)
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), vecs.data_ptr(), qq.data_ptr(),
            sq_masked.data_ptr(), t.data_ptr(), B, N, Dw, splits,
            c_gt.data_ptr(), c_eq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"count_gt_eq kernel launch failed: CUDA error {err}"
        )
    count_gt_eq.launches += 1
    return c_gt, c_eq


# Launches of the CUDA kernel in this process (see cuda_scan.flat_topk).
count_gt_eq.launches = 0
