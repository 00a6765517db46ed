"""Plain exact k nearest neighbours by Hamming distance: the reference of a
configuration whose ``metric`` is ``hamming``, found by that name, with
the three functions of ``euclidean.py`` beside it: ``knn``,
``pair_dist`` and ``similarity``.

Rows and queries are packed bit codes as the generator hands them and
the client takes them: 32 bits a word, uint32 (or int32) words, W a row.
The distance of two codes is the number of bits in which they differ.
The reference unpacks the bits to 0 / 1 in float32 and takes
``popc(q) + popc(x) - 2 q.x`` with TF32 off: every sum is an integer of
at most 32 W, exact in float32, so ``"fp64"`` (the name the harness asks
the exact form by) is exact. An integer metric has no lower float
precision, so the control (``"tf32"``, the name ``control.py`` asks for)
departs from the mathematics by the least it can: it scores the codes
one word short, on their first 32 (W - 1) bits. Both run in blocks of
queries so that a block's [B, N] distances fit beside the rows.

Imports nothing of the port or of the JAX package.
"""

from __future__ import annotations

import torch

from .euclidean import tf32_off

QUERY_BLOCK = 512
PAIR_BLOCK = 4096
SHIFTS = torch.arange(32, dtype=torch.int32)


def words32(codes: torch.Tensor) -> torch.Tensor:
    """Packed codes as int32 words, the same bits (a view where they
    are uint32)."""
    if codes.dtype == torch.int32:
        return codes
    if codes.dtype == torch.uint32:
        return codes.view(torch.int32)
    raise TypeError(f"packed codes are 32-bit words, not {codes.dtype}")


def unpack(codes: torch.Tensor) -> torch.Tensor:
    """[M, W] packed words -> [M, 32 W] float32 bits, 0 or 1 (bit j of
    word w at column 32 w + j)."""
    w = words32(codes)
    bits = (w[..., None] >> SHIFTS.to(w.device)) & 1
    return bits.reshape(w.shape[0], -1).float()


def knn(rows: torch.Tensor, queries: torch.Tensor, k: int,
        precision: str = "fp64"):
    """The ``k`` nearest of ``rows`` [N, W] to each of ``queries`` [Q, W]
    (packed words on one device). Returns ``(idx, dist)`` [Q, k], nearest
    first: int64 row numbers and Hamming distances as float64 (``"fp64"``:
    all 32 W bits; ``"tf32"``: the control, the first 32 (W - 1))."""
    if precision == "fp64":
        width = rows.shape[1]
    elif precision == "tf32":
        width = rows.shape[1] - 1
    else:
        raise ValueError(f"unknown precision {precision!r}")
    r = unpack(rows[:, :width])
    rn = r.sum(1)
    idx, dist = [], []
    with tf32_off():
        for lo in range(0, queries.shape[0], QUERY_BLOCK):
            qb = unpack(queries[lo : lo + QUERY_BLOCK, :width])
            d = (qb @ r.T).mul_(-2).add_(rn[None, :]).add_(qb.sum(1)[:, None])
            top = torch.topk(d, k, dim=1, largest=False, sorted=True)
            idx.append(top.indices)
            dist.append(top.values.double())
            del d
    return torch.cat(idx), torch.cat(dist)


def similarity(dist):
    """The similarity a reply reports for a row at distance ``dist``: the
    negated distance."""
    return -dist


def pair_dist(rows: torch.Tensor, queries: torch.Tensor, idx: torch.Tensor):
    """float64 Hamming distance of each query to each row it names, from
    the bits of their XOR: ``idx`` [Q, k] in range."""
    r, q = words32(rows), words32(queries)
    shifts = SHIFTS.to(r.device)
    out = []
    for lo in range(0, q.shape[0], PAIR_BLOCK):
        x = r[idx[lo : lo + PAIR_BLOCK]] ^ q[lo : lo + PAIR_BLOCK, None, :]
        out.append(((x[..., None] >> shifts) & 1).sum((-2, -1)).double())
    return torch.cat(out) if out else torch.empty(
        (0, idx.shape[1]), dtype=torch.float64, device=rows.device)
