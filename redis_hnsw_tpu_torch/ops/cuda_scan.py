"""Kernels A and A′: fused exact scan top-k.

Port of ``redis_hnsw_tpu/ops/pallas_scan.py::flat_topk_pallas`` (the
Pallas TPU kernel at pallas_scan.py:165, its pallas_call at :194). Per
query, the exact top-k rows of the whole table by the matmul-form score

    score = (2 * q.x - |q|^2) - sq_masked[row]

best first, ties to the lowest row id, ``-1`` / ``-inf`` in empty slots.
``sq_masked`` is the row sqnorm, ``+inf`` on a dead or padding row (score
``-inf``, never selected) -- the same encoding as the count kernel's, and
``-bias`` of the Pallas kernel's ``euclid_bias``.

A′ (:func:`flat_topk_hamming`, the Pallas kernel's ``_scan_kernel_hamming``
at pallas_scan.py:122) is the same selection over packed bit rows, int32
words (the uint32 words' bytes), by the score

    score = bias[row] - popcount(q XOR x)

with ``bias`` 0 on a live row and ``-inf`` on a dead one
(:func:`hamming_bias`). Its plain version is the JAX package's own
formulation (ops/scan.py ``pm1_table``, ``_chunk_scores``): the bits as a
+-1 f32 table, one matmul, ``(dot - d_bits) * 0.5``, exact because every
partial sum is an integer below 2^24.

* On a CUDA tensor, :func:`flat_topk` launches the hand-written CUDA
  kernel ``csrc/scan_topk.cu`` or raises. It scores on the fp32 core of
  ``csrc/l2_core.cuh`` (128 x 128 block tiles, 8 x 16 fp32 register
  tiles, a cp.async ring), which the count kernel (B) and kernel D share,
  so the certificates see bit-identical scores. Each score is
  tested in registers against its query's admission threshold; survivors
  go to a per-(split, query) heap in device memory, so every k is served.
  :func:`plan` cuts the rows into splits that fill whole waves of the
  card's resident blocks; a second kernel merges the splits' sorted
  lists (:func:`plain_merge_lists` is its plain version).
  :func:`flat_topk_hamming` launches kernel A′ on the same selection
  (heaps in device memory, the same merge, every k; splits planned from
  A′'s own resident blocks), scoring on the tensor cores: an int8
  ``mma.sync`` product of the queries' bits as +-1 bytes and the rows'
  as 0/1 bytes gives ``popcount(q) - popcount(q XOR x)`` exactly.
* On a CPU tensor they run :func:`plain_flat_topk` /
  :func:`plain_flat_topk_hamming`: ``CHUNK_N``-row chunks through
  ``torch.mm`` and :func:`chunked_topk` -- the kernels' references in the
  tests.

The bf16 and int8 scan tiers select with two more cores on kernel A's
selection (:func:`flat_topk_bf16`, :func:`flat_topk_int8`; kernels
A-bf16 of ``csrc/scan_bf16.cu`` and A-int8 of ``csrc/scan_int8.cu``,
each with scan_lowp.cu's form as its general form), for work that the
JAX package leaves to XLA; their section below gives their scores.

Bound on the H100: the scoring is 2*B*N*D fp32 operations (true fp32, no
tensor cores) against (B + N)*D*4 bytes, so it is compute-bound at the
serving shapes; A′ by 2*B*N*32W int8 tensor-core operations (its B*N*W
popcounts run at a small fraction of that rate on the CUDA cores). The
kernels' design is in csrc/scan_topk.cu. Their times beside those bounds
are in PERF.md, measured by chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from ..utils import profiling
from . import distance as D

NEG_INF = float("-inf")

TILE = 128  # queries, and rows, per block tile of kernels A and A′

# Queries a block tile of each kernel whose grid tiles the queries (by
# its CUDA source; A′ apart): a launch over B queries computes
# ceil(B / tile) * tile query lanes, filled or not. Each equals the CUDA
# constant its grid divides by (tests/test_torch_bench_clients.py reads
# the sources).
QUERY_TILE = {
    "scan_topk": 128,          # A: l2_core.cuh TILE_Q
    "scan_topk_hamming": 128,  # A′: hamming_mma.cuh TILE
    "scan_lowp": 128,          # A-bf16, A-int8 general form: TILE
    "scan_bf16": 128,          # A-bf16 wgmma form: Frame TILE_Q, 64 * CWG
    "scan_int8": 128,          # A-int8 wgmma form: the same
    "select_bins": 128,        # D: l2_core.cuh TILE_Q
    "count_gt_eq": 128,        # B: l2_core.cuh TILE_Q
    "count_hamming": 128,      # B′: count_hamming.cu QT
}


def count_lanes(kernel: str, B: int) -> None:
    """Add the query lanes a launch of ``kernel`` over ``B`` queries
    computed to the open request's ``scan_lanes`` (utils/profiling.py);
    called by each wrapper once its kernel is launched on the card."""
    tile = QUERY_TILE[kernel]
    profiling.count("scan_lanes", -(-B // tile) * tile)


# Rows scored per chunk by the plain version: bounds its [B, CHUNK_N]
# score tile. The plain count (ops/cuda_count.py) chunks identically, so
# on the CPU both passes of the certificate score through same-shaped
# matmuls.
CHUNK_N = 1 << 19

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_table(queries, table, row_op, k, dtype):
    """Shapes, k, element types and device shared by both score forms:
    queries [B, D] and table [N, D] of ``dtype``, a [N] f32 row operand."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if queries.dim() != 2 or table.dim() != 2:
        raise ValueError("queries [B, D] and the table [N, D] must be 2-D")
    if queries.shape[1] != table.shape[1]:
        raise ValueError(
            f"query width {queries.shape[1]} != table width {table.shape[1]}"
        )
    if tuple(row_op.shape) != (table.shape[0],):
        raise ValueError("the row operand (sq_masked, bias) must be [N]")
    for t, want in ((queries, dtype), (table, dtype),
                    (row_op, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"scan top-k takes {want}, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError("all operands must be on one device")


def check_operands(queries, vecs, sq_masked, qq, k):
    """Validate the scan kernels' operands (shared with ops/cuda_count.py
    and ops/cuda_select.py)."""
    _check_table(queries, vecs, sq_masked, k, torch.float32)
    if tuple(qq.shape) != (queries.shape[0],):
        raise ValueError("qq must be [B]")
    if qq.dtype != torch.float32:
        raise TypeError(f"scan top-k takes float32, got {qq.dtype}")
    if qq.device != queries.device:
        raise ValueError("all operands must be on one device")


def chunked_topk(scores_of, B, N, k, dev):
    """Top k by chunks, as the JAX package's XLA scan selects
    (redis_hnsw_tpu/ops/scan.py ``_select_merge``): ``scores_of(lo,
    hi)`` scores one ``CHUNK_N``-row chunk; a stable descending sort per
    chunk (row order breaks ties) and a merge with the running best --
    earlier chunks first, so equal scores keep the lower id. The plain
    versions select with it."""
    top_s = torch.full((B, 0), NEG_INF, dtype=torch.float32, device=dev)
    top_i = torch.full((B, 0), -1, dtype=torch.int32, device=dev)
    for lo in range(0, N, CHUNK_N):
        hi = min(lo + CHUNK_N, N)
        c_s, c_pos = torch.sort(scores_of(lo, hi), dim=1, descending=True,
                                stable=True)
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


def plain_flat_topk(queries, vecs, sq_masked, qq, *, k: int):
    """Plain PyTorch version of :func:`flat_topk`: chunked matmul-form
    scores (ops/distance.py pairwise_neg_sq_l2) through
    :func:`chunked_topk`."""
    return chunked_topk(
        lambda lo, hi: D.pairwise_neg_sq_l2(
            queries, vecs[lo:hi], sq_masked[lo:hi], qq
        ),
        queries.shape[0], vecs.shape[0], k, queries.device,
    )


def plain_merge_lists(part_s, part_i, k: int):
    """Plain version of kernel A's merge (``list_merge_kernel``): the best
    k of ``S`` per-split lists ``part_s``/``part_i`` [S, B, k], each
    sorted best first over a contiguous row range, split 0 lowest. Split
    order is row order, so a stable sort of the lists laid end to end
    keeps ties on the lower id. (-inf, -1) past the last real entry."""
    S, B, kk = part_s.shape
    flat_s = part_s.permute(1, 0, 2).reshape(B, S * kk)
    flat_i = part_i.permute(1, 0, 2).reshape(B, S * kk)
    top_s, pos = torch.sort(flat_s, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k]
    top_i = torch.gather(flat_i, 1, pos[:, :k])
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_i, top_s


def _lib():
    from ..utils.build import load_kernel

    lib = load_kernel("scan_topk")
    lib.scan_topk_launch.restype = _I
    lib.scan_topk_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                     _P, _P, _P]
    lib.scan_topk_slots.restype = _I
    lib.scan_topk_slots.argtypes = []
    lib.scan_topk_slab_len.restype = _I
    lib.scan_topk_slab_len.argtypes = [_I]
    lib.scan_topk_hamming_launch.restype = _I
    lib.scan_topk_hamming_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                             _P, _P, _P, _P]
    lib.scan_topk_hamming_slots.restype = _I
    lib.scan_topk_hamming_slots.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def block_slots(device_index: int) -> int:
    """Blocks of kernel A's split kernel that card ``device_index`` holds
    at once."""
    with torch.cuda.device(device_index):
        slots = _lib().scan_topk_slots()
    if slots <= 0:
        raise RuntimeError("scan_topk: cannot read the card's occupancy")
    return slots


@functools.lru_cache(maxsize=None)
def hamming_block_slots(device_index: int) -> int:
    """Blocks of kernel A′'s split kernel that card ``device_index``
    holds at once."""
    with torch.cuda.device(device_index):
        slots = _lib().scan_topk_hamming_slots()
    if slots <= 0:
        raise RuntimeError("scan_topk_hamming: cannot read the card's "
                           "occupancy")
    return slots


# A block's fixed work in kernel A′, in 128-row tiles: each split starts
# from an empty heap (its first tiles admit every row), merges and sorts
# its lists, and adds a list to the final merge. At B = 2048 over
# 1,000,064 rows on an H100, tools/hamming_core_study.cu timed one wave
# of 16 splits 12-18% faster (k = 10 and 40) than the two waves of 33
# that tile counts alone pick; 96 makes the planner take the 16.
HAMMING_SPLIT_TILES = 96


def plan(device, B: int, N: int, *, hamming: bool = False
         ) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of kernel A (or, with
    ``hamming``, A′) over B queries and N rows: kernel D's wave planner
    (ops/cuda_select.py plan_tiles) over the kernel's own resident
    blocks, with A′'s fixed work a block (``HAMMING_SPLIT_TILES``)."""
    from .cuda_select import plan_tiles

    if hamming:
        return plan_tiles(hamming_block_slots, device, B, N,
                          HAMMING_SPLIT_TILES)
    return plan_tiles(block_slots, device, B, N)


def flat_topk(queries, vecs, sq_masked, qq, *, k: int):
    """Exact top-k of every query over every row of ``vecs``.

    ``queries`` [B, D] f32, ``vecs`` [N, D] f32, ``sq_masked`` [N] f32
    (row sqnorms, +inf on dead rows), ``qq`` [B] f32 (query sqnorms,
    computed once by the caller). Returns (ids [B, k] int32, sims [B, k]
    f32) in (-sim, id) order with -1/-inf padding, at any ``k``. A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version.
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
    lib = _lib()
    splits, _ = plan(dev, B, N)
    slabs = torch.empty((splits, B, lib.scan_topk_slab_len(k), 2),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.scan_topk_launch(
            queries.data_ptr(), vecs.data_ptr(), qq.data_ptr(),
            sq_masked.data_ptr(), B, N, Dw, k, splits, slabs.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_topk kernel launch failed: CUDA error {err}")
    flat_topk.launches += 1
    count_lanes("scan_topk", B)
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


# -- kernel A′: hamming ---------------------------------------------------------

def hamming_bias(valid):
    """The hamming kernels' row operand: 0 on a live row, -inf on a dead
    one (the Pallas kernel's ``hamming_bias``)."""
    return torch.where(
        valid, torch.zeros(valid.shape, device=valid.device),
        torch.full(valid.shape, NEG_INF, device=valid.device),
    )


def pm1_table(words):
    """[N, W] int32 packed bits -> [N, 32W] f32 in {-1, +1} (the JAX
    package's ``pm1_table``, bit j of word w in column 32w + j). ``>>`` on
    int32 is arithmetic, which leaves bit j of ``x >> j`` as it was."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return (2 * bits - 1).reshape(words.shape[0], -1).float()


def hamming_scores(q_pm1, words, bias):
    """[B, n] hamming scores ``bias - popcount(q XOR x)`` of the +-1 query
    block ``q_pm1`` [B, 32W] against ``words`` [n, W], in the JAX
    package's matmul form ``(dot - d_bits) * 0.5`` -- exact, since every
    partial sum is an integer below 2^24. A live row's distance 0 scores
    +0.0, as the kernels' ``0 - 0`` does."""
    dots = torch.mm(q_pm1, pm1_table(words).t())
    return dots.sub_(q_pm1.shape[1]).mul_(0.5).add_(bias[None, :])


def plain_flat_topk_hamming(queries, words, bias, *, k: int):
    """Plain PyTorch version of :func:`flat_topk_hamming`: chunked
    :func:`hamming_scores` through :func:`chunked_topk`."""
    q_pm1 = pm1_table(queries)
    return chunked_topk(
        lambda lo, hi: hamming_scores(q_pm1, words[lo:hi], bias[lo:hi]),
        queries.shape[0], words.shape[0], k, queries.device,
    )


def flat_topk_hamming(queries, words, bias, *, k: int):
    """Exact hamming top-k of every query over every row of ``words``.

    ``queries`` [B, W] and ``words`` [N, W] int32 packed bits, ``bias``
    [N] f32 (:func:`hamming_bias`). Returns (ids [B, k] int32, sims
    [B, k] f32 = -distance) in (-sim, id) order with -1/-inf padding, at
    any ``k``. ``bias`` must be 0 or -inf: the kernel admits rows by
    their integer counts. A CUDA tensor launches kernel A′; a CPU tensor
    takes the plain version.
    """
    _check_table(queries, words, bias, k, torch.int32)
    if queries.device.type == "cpu":
        return plain_flat_topk_hamming(queries, words, bias, k=k)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    queries, words, bias = (t.contiguous() for t in (queries, words, bias))
    B, W = queries.shape
    N = words.shape[0]
    dev = queries.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_i, out_s
    lib = _lib()
    splits, _ = plan(dev, B, N, hamming=True)
    slabs = torch.empty((splits, B, lib.scan_topk_slab_len(k), 2),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.scan_topk_hamming_launch(
            queries.data_ptr(), words.data_ptr(), bias.data_ptr(), B, N, W,
            k, splits, slabs.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"scan_topk_hamming kernel launch failed: CUDA error {err}"
        )
    flat_topk_hamming.launches += 1
    count_lanes("scan_topk_hamming", B)
    return out_i, out_s


flat_topk_hamming.launches = 0


# -- kernels A-bf16 and A-int8: the bf16 and int8 scan tiers -------------------
#
# The JAX package scores these tiers in XLA (ops/scan.py ``_chunk_scores``:
# a bf16 or int8 jnp.dot, then lax.top_k per chunk). Here they score on the
# tensor cores under kernel A's selection (heaps in device memory,
# list_merge_kernel), so every k is served: A-bf16 on ``csrc/scan_bf16.cu``
# (warpgroup MMA on TMA-fed tiles, its queries resident, every row's exact
# score), A-int8 on ``csrc/scan_int8.cu`` (the same, with a
# one-add-max-a-score filter before the exact score), or, for rows they
# cannot take, scan_lowp.cu's general form (mma.sync on a cp.async ring):
#
#   bf16: score = (2 * dot - qq) - sq,            dot = bf16 q . bf16 x (f32)
#   int8: score = (2 * (dot * (qscale * tscale)) - qq) - sq,
#                                                  dot = int8 q . int8 x
#
# each step rounded on its own, in the JAX package's order
# (ops/scan.py:166-170). ``qq`` is the f32 queries' sqnorm and ``sq_masked``
# the f32 rows' (+inf on a dead row). The int8 dot is exact, so kernel and
# plain version agree bit for bit on any data; the bf16 products are exact
# in f32 and the tensor cores' sums round otherwise than a library
# matmul's, so the two agree bit for bit where every partial sum is exact
# (integer data) and to f32 rounding of the sums elsewhere.

def bf16_scores(q16, t16, sq_masked, qq):
    """[B, n] bf16-tier scores of the bf16 queries ``q16`` against the bf16
    rows ``t16``: an f32 matmul of the widened copies (every product exact)
    then ``(2 * dot - qq) - sq``."""
    dots = torch.mm(q16.float(), t16.float().t())
    return dots.mul_(2.0).sub_(qq[:, None]).sub_(sq_masked[None, :])


def int8_scores(q8, qscale, t8, tscale, sq_masked, qq):
    """[B, n] int8-tier scores: the exact int8 dots (an f32 matmul, exact
    while every partial sum is an integer below 2^24, i.e. up to
    ``D.INT8_F32_MAX_DIM``; f64 above), descaled as the JAX package does."""
    wide = (torch.float32 if q8.shape[1] <= D.INT8_F32_MAX_DIM
            else torch.float64)
    dots = torch.mm(q8.to(wide), t8.to(wide).t()).float()
    dots.mul_(qscale[:, None] * tscale[None, :]).mul_(2.0)
    return dots.sub_(qq[:, None]).sub_(sq_masked[None, :])


def plain_flat_topk_bf16(q16, t16, sq_masked, qq, *, k: int):
    """Plain PyTorch version of :func:`flat_topk_bf16`: chunked
    :func:`bf16_scores` through :func:`chunked_topk`."""
    t16 = t16[:, : q16.shape[1]]  # its 4-byte padding adds nothing
    return chunked_topk(
        lambda lo, hi: bf16_scores(q16, t16[lo:hi], sq_masked[lo:hi], qq),
        q16.shape[0], t16.shape[0], k, q16.device,
    )


def plain_flat_topk_int8(q8, qscale, t8, tscale, sq_masked, qq, *, k: int):
    """Plain PyTorch version of :func:`flat_topk_int8`: chunked
    :func:`int8_scores` through :func:`chunked_topk`."""
    t8 = t8[:, : q8.shape[1]]  # its 4-byte padding adds nothing
    return chunked_topk(
        lambda lo, hi: int8_scores(q8, qscale, t8[lo:hi], tscale[lo:hi],
                                   sq_masked[lo:hi], qq),
        q8.shape[0], t8.shape[0], k, q8.device,
    )


LOWP_CORES = {"bf16": 0, "int8": 1}


def _lowp_lib():
    from ..utils.build import load_kernel

    lib = load_kernel("scan_lowp")
    lib.scan_lowp_launch.restype = _I
    lib.scan_lowp_launch.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _P, _P, _P, _P]
    lib.scan_lowp_slots.restype = _I
    lib.scan_lowp_slots.argtypes = [_I]
    return lib


@functools.lru_cache(maxsize=None)
def lowp_block_slots(device_index: int, core: str) -> int:
    """Blocks of core ``core``'s split kernel that card ``device_index``
    holds at once."""
    with torch.cuda.device(device_index):
        slots = _lowp_lib().scan_lowp_slots(LOWP_CORES[core])
    if slots <= 0:
        raise RuntimeError(f"scan_lowp {core}: cannot read the card's "
                           "occupancy")
    return slots


def lowp_plan(device, B: int, N: int, core: str) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of core ``core`` ("bf16" or
    "int8"): :func:`plan`'s wave planner over the core's own resident
    blocks, with A′'s fixed work a split (the cores share its layout and
    its selection)."""
    from .cuda_select import plan_tiles

    return plan_tiles(lambda index: lowp_block_slots(index, core), device,
                      B, N, HAMMING_SPLIT_TILES)


def lowp_pad(width: int, elem_size: int) -> int:
    """Zero columns that pad a tier table's row of ``width`` elements of
    ``elem_size`` bytes to a multiple of 4 bytes, the cores' narrowest
    copy (an odd bf16 width, an int8 width not a multiple of 4)."""
    return (-width * elem_size % 4) // elem_size


def pad_lowp_rows(table):
    """``table`` [N, D] (bf16 or int8) with its rows zero-padded to a
    multiple of 4 bytes, which adds nothing to a dot: the tier tables are
    stored so, once an epoch, and the cores pad only the queries."""
    pad = lowp_pad(table.shape[1], table.element_size())
    return torch.nn.functional.pad(table, (0, pad)) if pad else table


def _check_lowp(q, t, sq_masked, qq, k, dtype):
    if q.dim() == 2 and t.dim() == 2:
        want = q.shape[1] + lowp_pad(q.shape[1], q.element_size())
        if t.shape[1] != want:
            raise ValueError(
                f"a tier table of query width {q.shape[1]} holds rows of "
                f"{want} columns (padded to 4 bytes by pad_lowp_rows), "
                f"got {t.shape[1]}"
            )
        t = t[:, : q.shape[1]]
    _check_table(q, t, sq_masked, k, dtype)
    if tuple(qq.shape) != (q.shape[0],) or qq.dtype != torch.float32:
        raise ValueError("qq must be [B] float32")
    if qq.device != q.device:
        raise ValueError("all operands must be on one device")


# The forms of kernels A-int8 and A-bf16 (``flat_topk_int8.forms`` and
# ``flat_topk_bf16.forms`` count launches by form): "wgmma",
# ``csrc/scan_int8.cu`` / ``csrc/scan_bf16.cu`` (warpgroup MMA on TMA-fed
# tiles), for rows of a multiple of 16 bytes (int8: up to
# INT8_WGMMA_MAX_ROW_BYTES) with every operand on a 16-byte boundary, a
# tensor map's terms; "general", ``csrc/scan_lowp.cu``'s lowp_tile_kernel
# (mma.sync on a cp.async ring), for the rest.
LOWP_FORMS = ("wgmma", "general")
INT8_WGMMA_MAX_ROW_BYTES = 32768  # scan_int8.cu MAX_ROW_BYTES


def int8_form(row_bytes: int, *ptrs: int) -> str:
    """The form of kernel A-int8 that takes rows of ``row_bytes`` bytes
    with its operands (queries, table, tscale, sq) at device addresses
    ``ptrs``."""
    if (row_bytes % 16 == 0 and row_bytes <= INT8_WGMMA_MAX_ROW_BYTES
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "general"


def bf16_form(row_bytes: int, *ptrs: int) -> str:
    """The form of kernel A-bf16 that takes rows of ``row_bytes`` bytes
    (2 D') with its operands (queries, table, sq) at device addresses
    ``ptrs``: :func:`int8_form`'s rule with no widest row (its sums are
    f32)."""
    if row_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "general"


def _ptr(x) -> int:
    """A CUDA operand's address as the launch passes it on (a
    non-contiguous operand goes as a fresh copy: counted as unaligned)."""
    return x.data_ptr() if x.is_contiguous() else 0


def int8_form_of(q8, t8, sq_masked, tscale) -> str:
    """The form :func:`flat_topk_int8` takes on these CUDA operands (the
    queries are passed on as they are where the table's rows are not
    padded, else as a fresh padded copy; non-contiguous operands as fresh
    copies)."""
    qptr = _ptr(q8) if q8.shape[1] == t8.shape[1] else 0
    return int8_form(t8.shape[1], qptr, _ptr(t8), _ptr(sq_masked),
                     _ptr(tscale))


def bf16_form_of(q16, t16, sq_masked) -> str:
    """The form :func:`flat_topk_bf16` takes on these CUDA operands (as
    :func:`int8_form_of`)."""
    qptr = _ptr(q16) if q16.shape[1] == t16.shape[1] else 0
    return bf16_form(2 * t16.shape[1], qptr, _ptr(t16), _ptr(sq_masked))


def _int8_lib():
    from ..utils.build import load_kernel

    lib = load_kernel("scan_int8")
    lib.scan_int8_launch.restype = _I
    lib.scan_int8_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _P, _P, _P, _P, _P]
    lib.scan_int8_slots.restype = _I
    lib.scan_int8_slots.argtypes = []
    return lib


def _bf16_lib():
    from ..utils.build import load_kernel

    lib = load_kernel("scan_bf16")
    lib.scan_bf16_launch.restype = _I
    lib.scan_bf16_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                     _P, _P, _P, _P]
    lib.scan_bf16_slots.restype = _I
    lib.scan_bf16_slots.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def wgmma_block_slots(device_index: int, core: str) -> int:
    """Blocks of core ``core``'s wgmma form ("int8": scan_int8.cu, "bf16":
    scan_bf16.cu) that card ``device_index`` holds at once."""
    with torch.cuda.device(device_index):
        slots = (_int8_lib().scan_int8_slots() if core == "int8"
                 else _bf16_lib().scan_bf16_slots())
    if slots <= 0:
        raise RuntimeError(f"scan_{core}: cannot read the card's occupancy")
    return slots


def wave_plan(slots: int, B: int, N: int) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of a wgmma form (A-int8's or
    A-bf16's: 128 queries a block) over B queries and N rows on a card
    holding ``slots`` of its blocks: one wave -- every query tile of every
    split resident at once, so each row range's tiles are read from device
    memory about once and the 128-query blocks sharing it meet in L2 --
    cut into as many equal splits as the wave holds and the rows allow,
    none empty. Past ``slots`` query tiles (B > 128 * slots) one split
    takes all the rows."""
    tiles = max(1, -(-N // TILE))
    q_tiles = max(1, -(-B // TILE))
    splits = max(1, min(slots // q_tiles, tiles, 65535))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def _card_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def wgmma_plan(device, B: int, N: int, core: str, form: str = "wgmma"
               ) -> tuple[int, int]:
    """(splits, 128-row tiles per split) of kernel A-``core`` ("int8"
    or "bf16") in ``form``: :func:`wave_plan` over its wgmma form's
    resident blocks, or the general form's :func:`lowp_plan`."""
    if form == "general":
        return lowp_plan(device, B, N, core)
    return wave_plan(wgmma_block_slots(_card_index(device), core), B, N)


def _launch_lowp(core, q, t, qq, qscale, sq_masked, tscale, k, form=None):
    """Launch core ``core`` on CUDA tensors in ``form`` (None: the one its
    operands take; "wgmma" raises on operands it cannot take); returns
    (ids, sims, form). The table's rows are already a multiple of 4 bytes
    (:func:`pad_lowp_rows`); the queries are zero-padded to its width
    here."""
    esize = q.element_size()
    if t.shape[1] != q.shape[1]:
        q = torch.nn.functional.pad(q, (0, t.shape[1] - q.shape[1]))
    q, t, qq, sq_masked = (x.contiguous() for x in (q, t, qq, sq_masked))
    if qscale is not None:
        qscale, tscale = qscale.contiguous(), tscale.contiguous()
    B, Dw = q.shape
    N = t.shape[0]
    dev = q.device
    if core == "int8":
        takes = int8_form_of(q, t, sq_masked, tscale)
        operands = (q, t, sq_masked, tscale)
        widest = f" (at most {INT8_WGMMA_MAX_ROW_BYTES})"
    else:
        takes = bf16_form_of(q, t, sq_masked)
        operands = (q, t, sq_masked)
        widest = ""
    form = takes if form is None else form
    if form == "wgmma" and takes != "wgmma":
        raise ValueError(
            f"kernel A-{core}'s wgmma form needs rows of a multiple of 16 "
            f"bytes{widest} with every operand on a 16-byte boundary, got "
            f"{Dw * esize}-byte rows, operands "
            f"{[x.data_ptr() % 16 for x in operands]} bytes past one")
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_i, out_s, form
    if form == "wgmma":
        splits, _ = wgmma_plan(dev, B, N, core)
        name, kernel = f"scan_{core} (wgmma form)", f"scan_{core}"
    else:
        splits, _ = lowp_plan(dev, B, N, core)
        name, kernel = f"scan_lowp {core} (general form)", "scan_lowp"
    slabs = torch.empty((splits, B, _lib().scan_topk_slab_len(k), 2),
                        dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = (out_s.data_ptr(), out_i.data_ptr(), stream)
    with torch.cuda.device(dev):
        if form == "wgmma":
            # the splits' shared k-th best per query (the launch zeroes it)
            kshare = torch.empty(B, dtype=torch.int32, device=dev)
            if core == "int8":
                err = _int8_lib().scan_int8_launch(
                    q.data_ptr(), t.data_ptr(), qq.data_ptr(),
                    qscale.data_ptr(), sq_masked.data_ptr(),
                    tscale.data_ptr(), B, N, Dw * esize, k, splits,
                    slabs.data_ptr(), kshare.data_ptr(), *tail)
            else:
                err = _bf16_lib().scan_bf16_launch(
                    q.data_ptr(), t.data_ptr(), qq.data_ptr(),
                    sq_masked.data_ptr(), B, N, Dw * esize, k, splits,
                    slabs.data_ptr(), kshare.data_ptr(), *tail)
        else:
            err = _lowp_lib().scan_lowp_launch(
                LOWP_CORES[core], q.data_ptr(), t.data_ptr(), qq.data_ptr(),
                None if qscale is None else qscale.data_ptr(),
                sq_masked.data_ptr(),
                None if tscale is None else tscale.data_ptr(), B, N,
                Dw * esize, k, splits, slabs.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_lanes(kernel, B)
    return out_i, out_s, form


def _check_form(form, forms, core):
    if form is not None and form not in forms:
        raise ValueError(f"unknown kernel A-{core} form {form!r}, not one "
                         f"of {forms}")


def flat_topk_bf16(q16, t16, sq_masked, qq, *, k: int,
                   form: str | None = None):
    """Top-k of every query over every row by the bf16 tier's score.

    ``q16`` [B, D] and ``t16`` [N, D'] bfloat16 (D' = D padded to 4
    bytes, :func:`pad_lowp_rows`), ``sq_masked`` [N] f32 (the f32 rows'
    sqnorms, +inf on dead rows), ``qq`` [B] f32 (the f32 queries'
    sqnorms). Returns (ids [B, k] int32, sims [B, k] f32) in
    (-sim, id) order with -1/-inf padding, at any ``k``. A CUDA tensor
    launches kernel A-bf16 (or raises) in the form its shape takes
    (:func:`bf16_form`); ``form`` forces one of :data:`LOWP_FORMS` (for
    tests and timing; "wgmma" raises on a shape it cannot take). A CPU
    tensor takes the plain version."""
    _check_form(form, LOWP_FORMS, "bf16")
    _check_lowp(q16, t16, sq_masked, qq, k, torch.bfloat16)
    if q16.device.type == "cpu":
        return plain_flat_topk_bf16(q16, t16, sq_masked, qq, k=k)
    if q16.device.type != "cuda":
        raise ValueError(f"unsupported device {q16.device}")
    ids, sims, form = _launch_lowp("bf16", q16, t16, qq, None, sq_masked,
                                   None, k, form)
    flat_topk_bf16.launches += 1
    flat_topk_bf16.forms[form] += 1
    return ids, sims


flat_topk_bf16.launches = 0
flat_topk_bf16.forms = Counter()


def flat_topk_int8(q8, qscale, t8, tscale, sq_masked, qq, *, k: int,
                   form: str | None = None):
    """Top-k of every query over every row by the int8 tier's score.

    ``q8`` [B, D] int8 with ``qscale`` [B] f32 and ``t8`` [N, D'] int8
    (D' = D padded to 4 bytes, :func:`pad_lowp_rows`) with ``tscale``
    [N] f32 (per-row symmetric quantization, ops/scan.py ``_to_int8``),
    ``sq_masked`` and ``qq`` as in :func:`flat_topk_bf16`. Same reply
    contract. A CUDA tensor launches kernel A-int8 (or raises) in the form
    its shape takes (:func:`int8_form`); ``form`` forces one of
    :data:`LOWP_FORMS` (for tests and timing; "wgmma" raises on a shape it
    cannot take). A CPU tensor takes the plain version."""
    _check_form(form, LOWP_FORMS, "int8")
    _check_lowp(q8, t8, sq_masked, qq, k, torch.int8)
    for s, n in ((qscale, q8.shape[0]), (tscale, t8.shape[0])):
        if tuple(s.shape) != (n,) or s.dtype != torch.float32:
            raise ValueError("qscale [B] and tscale [N] must be float32")
        if s.device != q8.device:
            raise ValueError("all operands must be on one device")
    if q8.device.type == "cpu":
        return plain_flat_topk_int8(q8, qscale, t8, tscale, sq_masked, qq,
                                    k=k)
    if q8.device.type != "cuda":
        raise ValueError(f"unsupported device {q8.device}")
    ids, sims, form = _launch_lowp("int8", q8, t8, qq, qscale, sq_masked,
                                   tscale, k, form)
    flat_topk_int8.launches += 1
    flat_topk_int8.forms[form] += 1
    return ids, sims


flat_topk_int8.launches = 0
flat_topk_int8.forms = Counter()
