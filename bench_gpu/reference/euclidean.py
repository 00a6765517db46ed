"""Plain exact k nearest neighbours by squared L2 distance: the reference
of a configuration whose ``metric`` is ``euclidean``, found by that name.
A reference of another metric is a file of its own beside this one, with
the same three functions: ``knn``, ``pair_dist`` and ``similarity``.

The reference computes every distance in float64 (the matmul form
``||q||^2 + ||x||^2 - 2 q.x``, whose cancellation error at float64 lies
some nine orders below the float32 rounding that the check measures);
the control is the same computation one precision below the float32
that the configurations state: TF32, the tensor cores' input format
(inputs rounded to 10 mantissa bits, products summed in float32), with
the norms in float32. Both run in blocks of queries so that a block's
[B, N] distances fit beside the rows.

Imports nothing of the port or of the JAX package.
"""

from __future__ import annotations

import contextlib

import torch

QUERY_BLOCK = 512
PAIR_BLOCK = 4096


@contextlib.contextmanager
def tf32_off():
    """float32 matrix products in float32 on the card (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest, ties
    to even, as the tensor cores read a float32 operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def knn(rows: torch.Tensor, queries: torch.Tensor, k: int,
        precision: str = "fp64"):
    """The ``k`` nearest of ``rows`` [N, D] to each of ``queries`` [Q, D]
    (float32 tensors on one device). Returns ``(idx, dist)`` [Q, k],
    nearest first: int64 row numbers and squared distances (float64 for
    ``precision="fp64"``, float32 for ``"tf32"``)."""
    if precision == "fp64":
        r = rows.double()
        rn = (r * r).sum(1)

        def dots(qb):
            return qb.double() @ r.T

        def norms(qb):
            qd = qb.double()
            return (qd * qd).sum(1)
    elif precision == "tf32":
        r32 = rows.float()
        rn = (r32 * r32).sum(1)
        rt = round_tf32(r32)

        def dots(qb):
            return round_tf32(qb.float()) @ rt.T

        def norms(qb):
            q32 = qb.float()
            return (q32 * q32).sum(1)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    idx, dist = [], []
    with tf32_off():
        for lo in range(0, queries.shape[0], QUERY_BLOCK):
            qb = queries[lo : lo + QUERY_BLOCK]
            d = dots(qb).mul_(-2).add_(rn[None, :]).add_(norms(qb)[:, None])
            top = torch.topk(d, k, dim=1, largest=False, sorted=True)
            idx.append(top.indices)
            dist.append(top.values)
            del d
    return torch.cat(idx), torch.cat(dist)


def similarity(dist):
    """The similarity a reply reports for a row at float64 distance
    ``dist``: the negated squared distance."""
    return -dist


def pair_dist(rows: torch.Tensor, queries: torch.Tensor, idx: torch.Tensor):
    """float64 direct-form squared distance ``||q_i - x_idx[i, j]||^2`` of
    each query to each row it names: ``idx`` [Q, k] in range."""
    out = []
    for lo in range(0, queries.shape[0], PAIR_BLOCK):
        q = queries[lo : lo + PAIR_BLOCK].double()
        x = rows[idx[lo : lo + PAIR_BLOCK]].double()
        out.append(((x - q[:, None, :]) ** 2).sum(-1))
    return torch.cat(out) if out else torch.empty(
        (0, idx.shape[1]), dtype=torch.float64, device=rows.device)
