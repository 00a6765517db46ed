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
  ``-(|q|^2 + |x|^2 - 2 q.x)`` for the plain scan, the direct-form rescore
  of the final k, and the ``(-sim, id)`` re-sort. The fused scan kernels
  live in ops/cuda_scan.py and ops/cuda_count.py.
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
    form the scan kernels compute, csrc/score.cuh). The plain versions
    of both scan kernels score through this one function, so on the
    CPU the selection and the certificate's count see the same bits."""
    if x_sqnorm is None:
        x_sqnorm = sqnorms(x)
    if qq is None:
        qq = sqnorms(q)
    dots = torch.mm(q, x.t())
    return dots.mul_(2.0).sub_(qq[:, None]).sub_(x_sqnorm[None, :])


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
