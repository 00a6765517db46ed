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
arithmetic: on CUDA, A′ sums them on its int8 tensor-core core
(``csrc/hamming_mma.cuh``) and B′ on the b1 tensor-core product.

* On a CUDA tensor, :func:`count_hamming` launches
  ``csrc/count_hamming.cu`` or raises: ``mma.sync`` m16n8k256 b1
  ``.and.popc`` on the packed words as they lie in memory (nothing
  expanded; popc(q ^ x) = popc(q) + popc(x) - 2 popc(q & x), each product
  starting from its row's -(popc(x) >> 1), computed once a stage), each
  warp streaming its own stages of rows through a cp.async ring, and a
  one-op filter epilogue: a running three-input max a (thread, query)
  over its rows, the exact compare-and-count only for the 16-query tiles
  whose max can pass; one integer atomic per (block, query) at the end. :func:`plan` cuts the rows into splits
  that fill whole waves of the card's resident blocks of this kernel.
  Rows of up to ``MAX_WORDS`` words.
* On a CPU tensor it runs :func:`plain_count_hamming`: ops/distance.py's
  shift-and-mask popcount over row chunks, then the two compare-sums --
  the kernel's reference in the tests.

Bound on the H100: (B/16)(N/8) ceil(W/8) b1 products at the int8
products' rate against (B + N)*W*4 bytes; the epilogue's one integer
operation a score sets a floor above both. Times in PERF.md
(chip_smoke.py, tools/kernel_times.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_scan
from . import distance as D

_P = ctypes.c_void_p
_I = ctypes.c_int

# The widest rows, in 32-bit words, the kernel takes (its shared memory
# grows with W past 64 words).
MAX_WORDS = 512

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
    lib.count_hamming_slots.argtypes = [_I]
    return lib


@functools.lru_cache(maxsize=None)
def block_slots(device_index: int, words: int) -> int:
    """Blocks of the kernel that card ``device_index`` holds at once over
    rows of ``words`` words (its shared memory grows with wide rows)."""
    with torch.cuda.device(device_index):
        slots = _lib().count_hamming_slots(words)
    if slots <= 0:
        raise RuntimeError("count_hamming: cannot read the card's occupancy")
    return slots


def plan(device, B: int, N: int, words: int = 8) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of a launch over B queries and N
    rows of ``words`` words: kernel D's wave planner (ops/cuda_select.py
    plan_tiles) over this kernel's own resident blocks."""
    from .cuda_select import plan_tiles

    return plan_tiles(lambda index: block_slots(index, words), device, B, N)


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
    if queries.shape[1] > MAX_WORDS:
        raise ValueError(f"count_hamming takes rows of at most {MAX_WORDS} "
                         f"words on the card, got {queries.shape[1]}")
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
    splits, _ = plan(dev, B, N, W)
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
    cuda_scan.count_lanes("count_hamming", B)
    return c_gt, c_eq


# Launches of the CUDA kernel in this process (see cuda_scan.flat_topk).
count_hamming.launches = 0
