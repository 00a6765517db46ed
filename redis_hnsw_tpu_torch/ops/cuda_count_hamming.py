"""Kernel B′: per-query hamming threshold counts for the certified tier.

The JAX package counts in XLA (``redis_hnsw_tpu/ops/scan.py``
``_count_vs_threshold_hamming``, :897): it scores the +-1 int8 table in
chunks, masks dead rows to -inf and sums ``score > t`` and ``score == t``
per query. For each query b, the counts of rows whose score

    score = bias[row] - popcount(q XOR x)

is ``> t[b]`` and ``== t[b]``, ``bias`` 0 on a live row and -inf on a
dead one (ops/cuda_scan.py ``hamming_bias``): a dead row counts as ``==``
against t = -inf only, as in the JAX package.

Soundness: the certificate (ops/scan.py ``scan_certified_hamming``)
compares these counts with the counts over kernel A′'s selection. Hamming
scores are small integers, exact on any unit, so the two passes agree by
arithmetic; on CUDA both kernels also score on the one int8 tensor-core
core of ``csrc/hamming_mma.cuh``.

* On a CUDA tensor, :func:`count_hamming` launches
  ``csrc/count_hamming.cu`` or raises: kernel A′'s loop (128 x 128 block
  tiles on ``mma.sync`` int8, a cp.async ring of row words) with a count
  epilogue -- two integer keys a query, two compares a count, 32 counters
  a thread in registers -- and one integer atomic per (block, query) at
  the end. :func:`plan` cuts the rows into splits that fill whole waves
  of the card's resident blocks of this kernel.
* On a CPU tensor it runs :func:`plain_count_hamming`: ops/distance.py's
  shift-and-mask popcount over row chunks, then the two compare-sums --
  the kernel's reference in the tests.

Bound on the H100: A′'s, 2*B*N*32W int8 tensor-core operations (B*N*W
popcounts on the CUDA cores) against (B + N)*W*4 bytes. Times in PERF.md
(chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_scan
from . import distance as D

_P = ctypes.c_void_p
_I = ctypes.c_int

# Query-row pairs a chunk of the plain version scores at once: bounds
# its [B, rows, W] int64 popcount tile (2 GiB).
PLAIN_PAIR_WORDS = 1 << 28


def plain_count_hamming(queries, words, bias, t):
    """Plain PyTorch version of :func:`count_hamming`: per chunk of rows,
    ``bias - popcount(q XOR x)`` by ops/distance.py's popcount, then the
    two compare-sums."""
    B, W = queries.shape
    N = words.shape[0]
    c_gt = torch.zeros(B, dtype=torch.int32, device=queries.device)
    c_eq = torch.zeros(B, dtype=torch.int32, device=queries.device)
    step = max(1, PLAIN_PAIR_WORDS // max(1, B * W))
    for lo in range(0, N, step):
        hi = min(lo + step, N)
        scores = D.pairwise_hamming(queries, words[lo:hi]).add_(
            bias[None, lo:hi])
        c_gt += (scores > t[:, None]).sum(dim=1, dtype=torch.int32)
        c_eq += (scores == t[:, None]).sum(dim=1, dtype=torch.int32)
    return c_gt, c_eq


def _lib():
    from ..utils.build import load_kernel

    lib = load_kernel("count_hamming")
    lib.count_hamming_launch.restype = _I
    lib.count_hamming_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P,
                                         _P, _P]
    lib.count_hamming_slots.restype = _I
    lib.count_hamming_slots.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def block_slots(device_index: int) -> int:
    """Blocks of the kernel that card ``device_index`` holds at once."""
    with torch.cuda.device(device_index):
        slots = _lib().count_hamming_slots()
    if slots <= 0:
        raise RuntimeError("count_hamming: cannot read the card's occupancy")
    return slots


def plan(device, B: int, N: int) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of a launch over B queries and N
    rows: kernel D's wave planner (ops/cuda_select.py plan_tiles) over
    this kernel's own resident blocks."""
    from .cuda_select import plan_tiles

    return plan_tiles(block_slots, device, B, N)


def count_hamming(queries, words, bias, t):
    """Per-query counts of hamming rows scoring (>, ==) ``t``.

    ``queries`` [B, W] and ``words`` [N, W] int32 packed bits, ``bias``
    [N] f32 (0 or -inf, :func:`~.cuda_scan.hamming_bias`), ``t`` [B] f32
    thresholds. Returns (c_gt, c_eq) [B] int32. A CUDA tensor launches
    kernel B′; a CPU tensor takes the plain version.
    """
    cuda_scan._check_table(queries, words, bias, 1, torch.int32)
    if tuple(t.shape) != (queries.shape[0],) or t.dtype != torch.float32:
        raise ValueError("t must be float32 [B]")
    if t.device != queries.device:
        raise ValueError("all operands must be on one device")
    if queries.device.type == "cpu":
        return plain_count_hamming(queries, words, bias, t)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    queries, words, bias, t = (
        x.contiguous() for x in (queries, words, bias, t)
    )
    B, W = queries.shape
    N = words.shape[0]
    dev = queries.device
    c_gt = torch.zeros(B, dtype=torch.int32, device=dev)
    c_eq = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return c_gt, c_eq
    launch = _lib().count_hamming_launch
    splits, _ = plan(dev, B, N)
    with torch.cuda.device(dev):
        err = launch(
            queries.data_ptr(), words.data_ptr(), bias.data_ptr(),
            t.data_ptr(), B, N, W, splits, c_gt.data_ptr(), c_eq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"count_hamming kernel launch failed: CUDA error {err}"
        )
    count_hamming.launches += 1
    return c_gt, c_eq


# Launches of the CUDA kernel in this process (see cuda_scan.flat_topk).
count_hamming.launches = 0
