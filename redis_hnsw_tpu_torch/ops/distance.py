"""Distance/similarity functions.

Port of ``redis_hnsw_tpu/ops/distance.py``. The similarity convention is
the reference's (zhao-lang/redis_hnsw src/hnsw/metrics.rs): **negative
squared L2** with no sqrt (metrics.rs:75, :80-83), so larger = closer and
all downstream ordering matches the reference exactly.

Two tiers:

* Host (numpy) functions -- the sequential, reference-parity graph
  mutation path, where candidate sets are tiny. Unchanged from the JAX
  package.
* Device (torch) functions on tensors -- matmul-form scoring
  ``-(|q|^2 + |x|^2 - 2 q.x)`` for the plain scan and the graph beam's
  frontier (row gathers, neighbour blocks, and their int8 forms), the
  direct-form rescore of the final k, and the ``(-sim, id)`` re-sort.
  The kernels live in ops/cuda_scan.py, ops/cuda_count.py and
  ops/cuda_gather.py; :func:`block_neg_sq_l2` is the plain version of the
  block kernel, and :func:`frontier_neg_sq_l2` of its row form.

Every dot of the frontier scorers sums in the fixed pairwise order of
:func:`_sum_last`, so a node's score depends only on the query and the
node, never on where in the tile it sits: the beam's dedup keeps one copy
of a node only because every re-proposal carries a bit-identical sim.

Hamming (packed bits as int32 words, the uint32 words' bytes):
:func:`pairwise_hamming`, :func:`block_hamming` and
:func:`frontier_hamming` score ``-popcount(q XOR x)`` with integer torch
ops on both devices, as the JAX package scores them in XLA. Torch has no
popcount, so :func:`_popcount` counts bits by shifts and masks on int64:
integer sims, exact on any data and any device.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Host (numpy) functions -- sequential mutation path.
# ---------------------------------------------------------------------------

def neg_sq_l2_np(q: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """-(sum((q - x)^2)) for one query against rows of ``xs``.

    Direct form (not matmul form) so values match the reference's scalar
    kernel (metrics.rs:79-84) to f32 rounding.
    """
    d = xs - q
    return -np.einsum("...d,...d->...", d, d)


def hamming_np(q_packed: np.ndarray, xs_packed: np.ndarray) -> np.ndarray:
    """Negative Hamming distance over uint32-packed bit vectors."""
    x = np.bitwise_xor(xs_packed, q_packed)
    # vectorized popcount via uint8 view + table
    v = x.view(np.uint8)
    return -_POPCOUNT_TABLE[v].sum(axis=-1).astype(np.float32)


_POPCOUNT_TABLE = np.array(
    [bin(i).count("1") for i in range(256)], dtype=np.uint16
)


def sim_np(q: np.ndarray, xs: np.ndarray, metric: str) -> np.ndarray:
    if metric == "euclidean":
        return neg_sq_l2_np(q, xs)
    if metric == "hamming":
        return hamming_np(q, xs)
    raise ValueError(metric)


# ---------------------------------------------------------------------------
# Device (torch) functions -- batched engines.
# ---------------------------------------------------------------------------

def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in a FIXED pairwise order: halve the width
    (zero-padded to a power of two) with elementwise adds until one
    column is left. Every element of the result is the same function of
    its own row alone, whatever the batch shape or the device -- unlike
    a library reduction, whose order may follow the tensor's shape. The
    certified scan relies on that: a query's norm and rescored sims must
    come out bit-identical when the query is served again in a smaller
    fallback batch (ops/scan.py certified_finish)."""
    w = x.shape[-1]
    p = 1
    while p < w:
        p *= 2
    if p != w:
        x = torch.nn.functional.pad(x, (0, p - w))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms (query norms ``qq`` of the scan kernels)."""
    return _sum_last(x * x)


def pairwise_neg_sq_l2(
    q: torch.Tensor,                      # [B, D]
    x: torch.Tensor,                      # [N, D]
    x_sqnorm: torch.Tensor | None = None,  # [N]
    qq: torch.Tensor | None = None,        # [B]
) -> torch.Tensor:                         # [B, N]
    """Matmul-form negative squared L2 of every query against every row:
    ``(2 * q.x - |q|^2) - |x|^2``, each step rounded on its own (the
    form the scan kernels compute, csrc/l2_core.cuh). The plain versions
    of both scan kernels score through this one function, so on the
    CPU the selection and the certificate's count see the same bits."""
    if x_sqnorm is None:
        x_sqnorm = sqnorms(x)
    if qq is None:
        qq = sqnorms(q)
    dots = torch.mm(q, x.t())
    return dots.mul_(2.0).sub_(qq[:, None]).sub_(x_sqnorm[None, :])


def _masked(mask: torch.Tensor, sims: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, sims, torch.full_like(sims, NEG_INF))


def _dots(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q [B, D] against x [B, ..., D] (any float type, widened to f32):
    [B, ...] dots summed in the fixed order of :func:`_sum_last`."""
    qb = q.reshape(q.shape[0], *([1] * (x.dim() - 2)), q.shape[1])
    return _sum_last(qb * x.float())


def frontier_neg_sq_l2(
    q: torch.Tensor,          # [B, D] f32
    q_sqnorm: torch.Tensor,   # [B]
    vecs: torch.Tensor,       # [N, D] full table
    vecs_sqnorm: torch.Tensor,  # [N]
    ids: torch.Tensor,        # [B, F] row ids (in range where masked)
    mask: torch.Tensor,       # [B, F] bool
) -> torch.Tensor:            # [B, F] sims, -inf where masked
    """Score a row-gathered frontier tile against its query batch:
    ``(2 * q.x - |q|^2) - |x|^2``. The hill climb, the entry point and
    seed scores, and the beam without a block table score through it."""
    ids = ids.long()
    sims = (2.0 * _dots(q, vecs[ids])).sub_(q_sqnorm[:, None])
    return _masked(mask, sims.sub_(vecs_sqnorm[ids]))


def block_neg_sq_l2(
    q: torch.Tensor,          # [B, D] f32
    q_sqnorm: torch.Tensor,   # [B]
    nbrvec: torch.Tensor,     # [N, F, D] neighbour blocks (f32/f16/bf16)
    nbrsqn: torch.Tensor,     # [N, F] f32 neighbour sqnorms
    cand: torch.Tensor,       # [B, E] parent row ids (in range)
    mask: torch.Tensor,       # [B, E*F] bool over the flattened frontier
) -> torch.Tensor:            # [B, E*F]
    """Frontier scoring through the snapshot's neighbour blocks
    (``nbrvec[x] = vecs[adj0[x]]``): each candidate's F neighbours are
    one contiguous [F, D] block, gathered per candidate instead of per
    row. The plain version of kernel C (ops/cuda_gather.py)."""
    B, E = cand.shape
    F = nbrvec.shape[1]
    cand = cand.long()
    dots = _dots(q, nbrvec[cand]).reshape(B, E * F)
    sims = (2.0 * dots).sub_(q_sqnorm[:, None])
    return _masked(mask, sims.sub_(nbrsqn[cand].reshape(B, E * F)))


# 1/127 rounded to f32. The JAX package writes ``amax / 127.0``; XLA
# compiles a division by a constant into a multiplication by its f32
# reciprocal, and the port computes what the JAX package's programs do,
# so int8 scales (and the snapshot's int8 tables) are bit-identical.
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quant_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 dequant scale: max|x| / 127 (1 for an
    all-zero row)."""
    amax = x.abs().amax(dim=-1)
    return torch.where(amax > 0, amax * INV127, torch.ones_like(amax)).float()


def quantize_query(q: torch.Tensor):
    """Per-row symmetric int8 quantization of a query batch:
    (q8 [B, D] int8, scale [B] f32)."""
    qs = quant_scale(q)
    q8 = torch.clamp(torch.round(q / qs[:, None]), -127, 127)
    return q8.to(torch.int8), qs


# Largest width whose int8 x int8 dots are exact in f32: every partial
# sum is an integer of magnitude <= 127^2 * D < 2^24.
INT8_F32_MAX_DIM = 1040


def _int8_dots(q8: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """Exact int8 dots as f32 (the JAX package's int32 dot, converted):
    torch has no CUDA int8 einsum, so both sides go to f32, where every
    partial sum is exact up to INT8_F32_MAX_DIM, or to f64 above it."""
    wide = torch.float32 if q8.shape[1] <= INT8_F32_MAX_DIM else torch.float64
    qb = q8.reshape(q8.shape[0], *([1] * (x8.dim() - 2)), q8.shape[1])
    return (qb.to(wide) * x8.to(wide)).sum(dim=-1).float()


def _int8_sims(dots, q_scale, s, q_sqnorm, fn):
    # the JAX package's order, each product rounded on its own
    sims = (2.0 * dots) * (q_scale[:, None] * s)
    return sims.sub_(q_sqnorm[:, None]).sub_(fn)


def frontier_int8_neg_sq_l2(
    q8: torch.Tensor,         # [B, D] int8 (quantize_query)
    q_scale: torch.Tensor,    # [B] f32
    q_sqnorm: torch.Tensor,   # [B] f32 (exact)
    qrows: torch.Tensor,      # [N, D+8] int8: x8 | bytes of (scale, sqn)
    ids: torch.Tensor,        # [B, F] (in range)
    mask: torch.Tensor,       # [B, F]
) -> torch.Tensor:
    """Quantized row-gathered frontier scoring (the high-D tier):
    ``2 * qs*s * <q8, x8> - |q|^2 - |x|^2`` with the row's dequant scale
    and exact sqnorm read from its packed last 8 bytes."""
    D = q8.shape[1]
    fv = qrows[ids.long()]                         # [B, F, D+8] int8
    meta = fv[..., D:].contiguous().view(torch.float32)  # [B, F, 2]
    dots = _int8_dots(q8, fv[..., :D])
    sims = _int8_sims(dots, q_scale, meta[..., 0], q_sqnorm, meta[..., 1])
    return _masked(mask, sims)


def block_int8_neg_sq_l2(
    q8: torch.Tensor,         # [B, D] int8 (quantize_query)
    q_scale: torch.Tensor,    # [B] f32
    q_sqnorm: torch.Tensor,   # [B] f32 (exact)
    nbrvec8: torch.Tensor,    # [N, F, D] int8 neighbour blocks
    nbrmeta: torch.Tensor,    # [N, 2F] f32: scales[:F] ++ sqnorms[F:]
    cand: torch.Tensor,       # [B, E] parent row ids (in range)
    mask: torch.Tensor,       # [B, E*F]
) -> torch.Tensor:
    """Blocked + quantized frontier scoring (the int8 block tier): int8
    neighbour blocks, with each neighbour's (dequant scale, exact
    sqnorm) in one flat [N, 2F] f32 meta row per parent."""
    B, E = cand.shape
    F = nbrvec8.shape[1]
    cand = cand.long()
    meta = nbrmeta[cand]                            # [B, E, 2F]
    s = meta[:, :, :F].reshape(B, E * F)
    fn = meta[:, :, F:].reshape(B, E * F)
    dots = _int8_dots(q8, nbrvec8[cand]).reshape(B, E * F)
    return _masked(mask, _int8_sims(dots, q_scale, s, q_sqnorm, fn))


def exact_neg_sq_l2(
    q: torch.Tensor,       # [B, D]
    vecs: torch.Tensor,    # [N, D]
    ids: torch.Tensor,     # [B, K] (in range)
    mask: torch.Tensor,    # [B, K] bool
) -> torch.Tensor:
    """Direct-form -(q-x)^2 for a small id set (final reported sims).

    The matmul form loses ~1e-3 relative precision to cancellation; final
    k results are rescored in direct form so reported similarities match
    the reference's kernel to f32 rounding. Summed in the fixed order of
    :func:`_sum_last`.
    """
    d = vecs[ids] - q[:, None, :]
    sims = -_sum_last(d * d)
    return torch.where(mask, sims, torch.full_like(sims, NEG_INF))


def resort_desc(ids: torch.Tensor, sims: torch.Tensor):
    """Re-sort [B, K] results descending by (sim, -id) after rescoring.

    Exact-form rescoring can reorder near-ties relative to the matmul-form
    selection order; the reply is strictly descending by similarity, ties
    broken by the lower id. ``torch.topk`` and a plain sort give no tie
    order, so this sorts by id, then stably by ``-sim``.
    """
    by_id = torch.argsort(ids, dim=1, stable=True)
    ids = torch.gather(ids, 1, by_id)
    sims = torch.gather(sims, 1, by_id)
    order = torch.argsort(-sims, dim=1, stable=True)
    return torch.gather(ids, 1, order), torch.gather(sims, 1, order)


# -- Hamming (packed bits, int32 words) --------------------------------------

def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word of ``x``, as int64. Widened to int64
    and masked to the word's 32 bits first, so no shift fills sign bits
    and no sum overflows; then the shift-and-mask (SWAR) steps."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def _neg_hamming(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``-popcount(q XOR x)`` summed over the last (word) dim, as f32
    (-0.0 at distance 0, as the JAX package's ``-sum(...).astype``)."""
    return -_popcount(torch.bitwise_xor(q, x)).sum(dim=-1).to(torch.float32)


def pairwise_hamming(
    q: torch.Tensor,   # [B, W] int32
    x: torch.Tensor,   # [N, W] int32
) -> torch.Tensor:     # [B, N] f32 negative hamming distance
    return _neg_hamming(q[:, None, :], x[None, :, :])


def block_hamming(
    q: torch.Tensor,          # [B, W] int32
    nbrvec: torch.Tensor,     # [N, F, W] int32 neighbour blocks
    cand: torch.Tensor,       # [B, E] parent row ids (in range)
    mask: torch.Tensor,       # [B, E*F]
) -> torch.Tensor:            # [B, E*F]
    """Hamming frontier scores through the neighbour blocks (the packed
    words of each candidate's neighbours, ops/snapshot.py)."""
    B, E = cand.shape
    F = nbrvec.shape[1]
    blocks = nbrvec[cand.long()]                      # [B, E, F, W]
    sims = _neg_hamming(q[:, None, None, :], blocks).reshape(B, E * F)
    return _masked(mask, sims)


def frontier_hamming(
    q: torch.Tensor,          # [B, W] int32
    vecs: torch.Tensor,       # [N, W] int32
    ids: torch.Tensor,        # [B, F] (in range)
    mask: torch.Tensor,       # [B, F]
) -> torch.Tensor:
    """Hamming scores of row-gathered frontier rows."""
    return _masked(mask, _neg_hamming(q[:, None, :], vecs[ids.long()]))
