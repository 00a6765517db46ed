"""Kernel B: per-query threshold counts for the scan certificate.

Port of ``redis_hnsw_tpu/ops/pallas_count.py::count_gt_eq`` (the Pallas
TPU kernel at pallas_count.py:78, its pallas_call at :103). For each query
b, the counts of rows whose matmul-form score

    score = (2 * q.x - |q|^2) - sq_masked[row]

is ``> t[b]`` and ``== t[b]``. Dead rows carry ``sq_masked = +inf`` and
score ``-inf``.

Soundness: the certificate (ops/scan.py) compares these counts with the
counts over the selected scores, so the recomputed scores must be
bit-identical to the selection pass's. On CUDA kernels A and B score on
the one fp32 core of ``csrc/l2_core.cuh`` (a sequential fp32 FMA chain
over the dims, then explicitly rounded subtractions), so they are by
arithmetic; on the CPU both plain versions score through ops/distance.py
``pairwise_neg_sq_l2`` over the same ``CHUNK_N`` chunks. The
every-256th-batch audit in ops/scan.py certified_finish still turns any
residual drift into a counted, repaired signal.

* On a CUDA tensor, :func:`count_gt_eq` launches ``csrc/count_gt_eq.cu``
  or raises: kernel A's loop (128 x 128 block tiles, 8 x 16 fp32 register
  tiles, a cp.async ring) with a count epilogue -- per tile one compare
  per score (s >= t); only where a score of a warp reaches t, the exact
  counts, an 8-lane shuffle sum per query and one add into the query's
  counters in shared memory -- and one integer atomic per (block,
  query) at the end. :func:`plan` cuts the rows into splits that
  fill whole waves of the card's resident blocks of this kernel.
* On a CPU tensor it runs :func:`plain_count_gt_eq` (chunked masked sums),
  the kernel's reference in the tests.

Bound on the H100: 2*B*N*D fp32 operations against (B + N)*D*4 bytes --
compute-bound, like the selection (7.8 ms at B = 2048, N = 1,000,064,
D = 128). Times in PERF.md (chip_smoke.py, tools/kernel_times.py).
"""

from __future__ import annotations

import ctypes
import functools

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


def _lib():
    from ..utils.build import load_kernel

    lib = load_kernel("count_gt_eq")
    lib.count_gt_eq_launch.restype = _I
    lib.count_gt_eq_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _P, _P, _P]
    lib.count_gt_eq_slots.restype = _I
    lib.count_gt_eq_slots.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def block_slots(device_index: int) -> int:
    """Blocks of the kernel that card ``device_index`` holds at once."""
    with torch.cuda.device(device_index):
        slots = _lib().count_gt_eq_slots()
    if slots <= 0:
        raise RuntimeError("count_gt_eq: cannot read the card's occupancy")
    return slots


def plan(device, B: int, N: int) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of a launch over B queries and N
    rows: kernel D's wave planner (ops/cuda_select.py plan_tiles) over
    this kernel's own resident blocks."""
    from .cuda_select import plan_tiles

    return plan_tiles(block_slots, device, B, N)


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
    launch = _lib().count_gt_eq_launch
    splits, _ = plan(dev, B, N)
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
    cuda_scan.count_lanes("count_gt_eq", B)
    return c_gt, c_eq


# Launches of the CUDA kernel in this process (see cuda_scan.flat_topk).
count_gt_eq.launches = 0
