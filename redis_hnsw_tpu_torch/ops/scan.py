"""Exact scan engine: brute-force k-NN over the index snapshot.

Port of the euclidean-f32 and hamming parts of ``redis_hnsw_tpu/ops/scan.py``.
Below
``ops/search.py`` SCAN_MAX_ROWS the scan serves ``search_batch``: it is
exact (recall 1.0), and a whole query batch against the whole table is
one dense pass that a GPU runs well.

Two tiers, chosen per table by :func:`cert_enabled`:

* **exact** (:func:`scan_topk_exact_l2`): kernel A (ops/cuda_scan.py)
  selects the top k by matmul-form score, at any k, the k are rescored
  in exact direct form and re-sorted by ``(-sim, id)``.
* **certified-exact** (:func:`scan_certified_l2`, at >= CERT_MIN_ROWS rows
  and <= CERT_MAX_DIM dims): kernel A selects ``k_sel = oversample * k``
  and keeps the top k, then kernel B (ops/cuda_count.py) counts, per
  query, the rows scoring above and at the k-th selected score t. A query
  is certified iff

      count_all(score >  t) == count_selected(score >  t)   and
      count_all(score == t) == count_selected(score == t)

  (no unselected row beats t, and the whole tie class at t was selected,
  so tie membership matches the exact top-k). Uncertified queries are
  served again through the exact tier (:func:`certified_finish`), so the
  reply is byte-identical to the exact tier's on every query. Soundness
  needs the count to recompute the selection's scores bit for bit: both
  kernels compute each score on the one fp32 core of ``csrc/l2_core.cuh``
  (an in-order FMA chain, then explicitly rounded subtractions). Every
  CERT_AUDIT_EVERY-th certified batch is also re-served exactly and
  byte-compared.

  In the JAX package the certified tier buys a cheap approximate select
  (``approx_max_k``) back to exactness. Kernel A's selection is exact
  already, so here the certificate only refuses tie classes cut at k;
  whether the tier still pays for its second pass on the H100 is an open
  question in ROADMAP.md.

  Its **one-pass form** (:func:`_certified_onepass`, the default where
  ``k <= N/128``; REDIS_HNSW_TPU_CERT_ONEPASS=0 keeps the two passes)
  selects and proves with kernel D (ops/cuda_select.py) in one pass over
  the table: the stable top k of the per-bin best rows is the exact top k
  whenever the largest second-best of any bin, m2, is below its k-th
  score.

**Hamming** tables are packed bit rows, int32 words, served on the exact
tier alone at every size: kernel A′ (:func:`scan_topk_exact_hamming`)
selects by integer scores, exact in f32, so its top k needs no rescore
and no certificate; like kernel A, it serves every k. (The JAX
package's certified hamming tier buys its approximate select back to
exactness; on the H100 a second pass only halves the throughput,
PERF.md.) Replies carry ``-distance`` with a zero
distance as -0.0, as the JAX package's word-packed reply decodes it.

The **scan-approx** tier (``approx=True``) is served on the exact tier
(:func:`serve_block`), and REDIS_HNSW_TPU_REPLY=ids copies only a
euclidean reply's ids off the card and rescores its sims on the host
(:func:`reply_ids_engaged`).

The JAX package's TPU-link machinery (fetch windows, pipelined drains,
packed int32 replies) reduces to a plain chunk loop here: the replies
are the same.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import distance as D
from .cuda_count import count_gt_eq
from .cuda_scan import (
    euclid_sq_masked,
    flat_topk,
    flat_topk_hamming,
    hamming_bias,
)
from .cuda_select import BIN_L, select_bins

NEG_INF = float("-inf")


def scan_oversample() -> int:
    """Selection width factor of the certified tier: kernel A keeps
    k_sel = factor * k candidates before the top k are certified
    (REDIS_HNSW_TPU_SCAN_OVERSAMPLE, default 4, as in the JAX
    package)."""
    v = os.environ.get("REDIS_HNSW_TPU_SCAN_OVERSAMPLE", "4")
    try:
        return max(1, int(v))
    except ValueError:
        raise ValueError(f"REDIS_HNSW_TPU_SCAN_OVERSAMPLE={v!r}")


def scan_dtype(metric: str = "euclidean") -> str:
    """Euclidean scan-table tier, REDIS_HNSW_TPU_SCAN_DTYPE. Only ``f32``
    (the default; selection is exactly exact) is ported; the bf16 and
    int8 tiers raise on a euclidean table. A hamming table ignores the
    tier, as in the JAX package."""
    v = os.environ.get("REDIS_HNSW_TPU_SCAN_DTYPE", "f32")
    if v not in ("f32", "bf16", "int8"):
        raise ValueError(f"REDIS_HNSW_TPU_SCAN_DTYPE={v!r}")
    if v != "f32" and metric == "euclidean":
        raise NotImplementedError(
            f"REDIS_HNSW_TPU_SCAN_DTYPE={v} (bf16/int8 scan tiers) is not "
            "ported yet (ROADMAP queue 1 item 9)"
        )
    return v


def onepass_enabled() -> bool:
    """REDIS_HNSW_TPU_CERT_ONEPASS, the JAX package's grammar: 0 keeps the
    certified tier's two-pass form (kernels A and B), 1 takes the one-pass
    form (kernel D), anything else but auto raises. auto (the default) is
    on here, where the JAX package leaves it off: on the H100 one pass of
    kernel D served flat-sift1m 1.52x faster than kernels A + B (PERF.md).
    Where the one-pass proof fails (m2 >= t), the query is served again
    by the exact tier."""
    v = os.environ.get("REDIS_HNSW_TPU_CERT_ONEPASS", "auto")
    if v in ("1", "auto"):
        return True
    if v == "0":
        return False
    raise ValueError(f"REDIS_HNSW_TPU_CERT_ONEPASS={v!r}")


def scan_topk(vecs, sqn, live, queries, *, k: int, k_sel: int | None = None,
              metric: str = "euclidean"):
    """Top-k of every query against every live row.

    ``vecs`` [N, D] f32 (= snapshot vecs) with ``sqn`` [N] row sqnorms,
    scored in matmul form by kernel A; or, with ``metric="hamming"``,
    [N, W] int32 packed bits scored by kernel A′ (``sqn`` unused).
    ``live`` [N] bool masks real, undeleted rows. The kernel selects
    ``k_sel`` (default ``k``) rows and the best ``k`` are kept. Returns
    (ids, sims) sorted descending by (sim, -id) -- the kernels' own order
    -- with -1/-inf in empty slots. Both kernels serve every k.
    """
    k_sel = k if k_sel is None else max(int(k_sel), k)
    if metric == "hamming":
        ids, sims = flat_topk_hamming(
            queries, vecs, hamming_bias(live), k=k_sel
        )
    else:
        ids, sims = flat_topk(
            queries, vecs, euclid_sq_masked(sqn, live), D.sqnorms(queries),
            k=k_sel,
        )
    return ids[:, :k], sims[:, :k]


def hamming_reply_sims(sims):
    """Kernel A′'s scores as the reply carries them: ``-distance``, with a
    zero distance as -0.0 where the kernel gives +0.0 (``0 - 0``). The
    JAX package's word-packed reply decodes ``-float(dist)`` and its graph
    engine scores ``-popcount``, so both give -0.0 there."""
    return (0.0 - sims).neg_()


def scan_topk_exact_hamming(words, live, queries, *, k: int):
    """The exact hamming tier: kernel A′'s top k, already in ``(-sim,
    id)`` order, with the reply's sims (:func:`hamming_reply_sims`)."""
    ids, sims = scan_topk(words, None, live, queries, k=k, metric="hamming")
    return ids, hamming_reply_sims(sims)


def scan_topk_exact_l2(vecs, sqn, live, queries, *, k: int,
                       k_sel: int | None = None):
    """Euclidean scan + exact direct-form rescore of the final k (the
    matmul form loses ~1e-3 relative to cancellation; reported sims
    must match the reference kernel to f32 rounding, metrics.rs:79-84),
    re-sorted by ``(-sim, id)``."""
    ids, sims = scan_topk(vecs, sqn, live, queries, k=k, k_sel=k_sel)
    sims = D.exact_neg_sq_l2(
        queries, vecs, ids.clamp(min=0).long(), sims != NEG_INF
    )
    return D.resort_desc(ids, sims)


# -- certified-exact selection ------------------------------------------------

CERT_MIN_ROWS = 1 << 19

# The certificate pays a second D-scaled pass over the table. The JAX
# package measured its break-even against the exact tier on its own
# hardware and engages through 768 padded dims; the gate is kept as is
# until the H100 measures its own (ROADMAP.md open questions).
CERT_MAX_DIM = 768

# Observability for tests and benchmarks: batches served by the
# certified path, and how many queries needed the exact fallback.
CERT_STATS = {"batches": 0, "queries": 0, "fallback_queries": 0}


def cert_enabled(n_rows: int, dim: int = 0) -> bool:
    """Should the certified-exact tier serve this scan? 0/1 force; auto
    engages at >= CERT_MIN_ROWS rows AND <= CERT_MAX_DIM dims
    (REDIS_HNSW_TPU_SCAN_CERT_MAX_DIM overrides). ``dim`` <= 0 skips
    the dim gate."""
    v = os.environ.get("REDIS_HNSW_TPU_SCAN_CERT", "auto")
    if v == "0":
        return False
    if v == "1":
        return True
    if v == "auto":
        try:
            max_dim = int(
                os.environ.get("REDIS_HNSW_TPU_SCAN_CERT_MAX_DIM")
                or CERT_MAX_DIM
            )
        except ValueError:
            max_dim = CERT_MAX_DIM
        return n_rows >= CERT_MIN_ROWS and (dim <= 0 or dim <= max_dim)
    raise ValueError(f"REDIS_HNSW_TPU_SCAN_CERT={v!r}")


def _cert_verify(vecs, sqn, live, queries, ids, sims):
    """Certificate + exact rescore over a selection. Returns ``(ids,
    sims, ok)``: the rescored ``(-sim, id)``-ordered reply and the [B]
    bool verdicts."""
    t = sims[:, -1].contiguous()
    s_gt = (sims > t[:, None]).sum(dim=1, dtype=torch.int32)
    s_eq = (sims == t[:, None]).sum(dim=1, dtype=torch.int32)
    c_gt, c_eq = count_gt_eq(
        vecs, euclid_sq_masked(sqn, live), queries, D.sqnorms(queries), t
    )
    # c_gt == s_gt must hold even when t == -inf: there it asserts that
    # EVERY live row (all score finite, so all > -inf) is among the
    # selected -- the k-th slot is empty because fewer than k live rows
    # exist. Only the tie-class equality is escaped at t == -inf, where
    # c_eq counts dead rows.
    ok = (c_gt == s_gt) & ((t == NEG_INF) | (c_eq == s_eq))
    sims = D.exact_neg_sq_l2(
        queries, vecs, ids.clamp(min=0).long(), sims != NEG_INF
    )
    ids, sims = D.resort_desc(ids, sims)
    return ids, sims, ok


def _certified_onepass(vecs, sqn, live, queries, *, k: int):
    """One-pass certified select: kernel D gives each query's per-bin
    best (score, row id) and m2, the largest second-best of any bin. The
    stable top k over those candidates, whose k-th score is t, is PROVABLY
    the exact top k, tie class at t included, when ``m2 < t``: a row that
    is not a candidate scores <= m2. The candidates ascend by row id and
    a stable descending sort keeps ties in that order, so ties go to the
    lower id, as in kernel A (torch.topk gives no tie order). Same
    ``(ids, sims, ok)`` contract as the two-pass form; t = -inf (fewer
    than k live candidates) never certifies."""
    sims_c, ids_c, m2 = select_bins(
        vecs, euclid_sq_masked(sqn, live), queries, D.sqnorms(queries)
    )
    top_sims, pos = torch.sort(sims_c, dim=1, descending=True, stable=True)
    top_sims = top_sims[:, :k]
    top_ids = torch.gather(ids_c, 1, pos[:, :k])
    top_ids = torch.where(top_sims == NEG_INF, -1, top_ids)
    ok = m2 < top_sims[:, -1]
    sims = D.exact_neg_sq_l2(
        queries, vecs, top_ids.clamp(min=0).long(), top_sims != NEG_INF
    )
    ids, sims = D.resort_desc(top_ids, sims)
    return ids, sims, ok


def scan_certified_l2(vecs, sqn, live, queries, *, k: int):
    """Oversampled selection (kernel A at ``k_sel = scan_oversample() *
    k``, the best k kept), certificate (kernel B) and exact rescore.
    Returns ``(ids, sims, ok)`` device tensors: :func:`scan_topk_exact_l2`'s
    reply contract plus the per-query verdict (True = PROVABLY the exact
    matmul-form top-k; False = the caller must rerun it through the
    exact tier). Queries with fewer than k live rows certify through the
    c_gt equality (every live row selected). With the one-pass form on
    (the default) and k at most the bin count, kernel D serves instead
    (:func:`_certified_onepass`)."""
    if onepass_enabled() and k <= max(1, int(vecs.shape[0]) // BIN_L):
        return _certified_onepass(vecs, sqn, live, queries, k=k)
    # kernel A selects at any width, so k_sel needs no clamp but N; kernel
    # B only ever counts against a selection kernel A made (their scores
    # share their bits)
    k_sel = min(scan_oversample() * k, int(vecs.shape[0]))
    ids, sims = scan_topk(vecs, sqn, live, queries, k=k, k_sel=k_sel)
    return _cert_verify(vecs, sqn, live, queries, ids, sims)


def pad_pow2(n: int, floor: int = 8) -> int:
    """Smallest power of two >= n (and >= floor): the batch-padding rule
    shared by every scan entry, as in the JAX package."""
    p = floor
    while p < n:
        p *= 2
    return p


# Every CERT_AUDIT_EVERY-th certified batch is re-served through the
# exact tier and byte-compared (REDIS_HNSW_TPU_SCAN_CERT_AUDIT overrides;
# 0 disables). Kernels A and B share their score routine, so a mismatch
# would mean a broken kernel: the audit turns it from silent wrongness
# into a counted, repaired signal (CERT_STATS audits/audit_mismatches;
# mismatched batches are served the exact result).
CERT_AUDIT_EVERY = int(
    os.environ.get("REDIS_HNSW_TPU_SCAN_CERT_AUDIT", "256") or 0
)


def _exact_rows(vecs, sqn, live, qd, rows, *, k: int):
    """Exact-tier reply of the query rows ``rows`` of ``qd``, served in
    one pow2-padded batch (numpy ids, sims)."""
    nb = len(rows)
    sel = np.zeros(pad_pow2(nb), np.int64)
    sel[:nb] = rows
    q_bad = qd[torch.from_numpy(sel).to(qd.device)]
    ids, sims = scan_topk_exact_l2(vecs, sqn, live, q_bad, k=k)
    return ids[:nb].cpu().numpy(), sims[:nb].cpu().numpy()


def certified_finish(vecs, sqn, live, qd, result, *, k: int, n_q: int,
                     rerun_sink=None):
    """Host half of the certified tier: fetch the reply and the
    verdicts of :func:`scan_certified_l2`'s ``result``, then re-serve
    the uncertified queries through the exact tier.

    ``rerun_sink`` (a :class:`CertRerunSink`) defers the fallback rerun:
    uncertified rows are registered with the sink and patched when the
    caller flushes it, so a multi-batch loop serves them all in one
    exact batch. Audit batches and the pathological whole-batch fallback
    stay immediate."""
    ids_d, sims_d, ok_d = result
    ids = ids_d[:n_q].cpu().numpy()
    sims = sims_d[:n_q].cpu().numpy()
    okh = ok_d[:n_q].cpu().numpy()
    CERT_STATS["batches"] += 1
    CERT_STATS["queries"] += n_q
    audit = (
        CERT_AUDIT_EVERY > 0
        and CERT_STATS["batches"] % CERT_AUDIT_EVERY == 0
    )
    deferred_bad = None
    if not okh.all() or audit:
        bad = np.flatnonzero(~okh)
        CERT_STATS["fallback_queries"] += len(bad)
        if audit or len(bad) * 4 > n_q:
            # audit pass, or pathological (tie-heavy / adversarial) data
            # where the whole batch beats many small reruns
            f_ids, f_sims = scan_topk_exact_l2(vecs, sqn, live, qd, k=k)
            f_ids = f_ids[:n_q].cpu().numpy()
            f_sims = f_sims[:n_q].cpu().numpy()
            if audit:
                CERT_STATS["audits"] = CERT_STATS.get("audits", 0) + 1
                if not (
                    np.array_equal(ids[okh], f_ids[okh])
                    and np.array_equal(
                        sims[okh].view(np.int32), f_sims[okh].view(np.int32)
                    )
                ):
                    CERT_STATS["audit_mismatches"] = (
                        CERT_STATS.get("audit_mismatches", 0) + 1
                    )
            ids, sims = f_ids, f_sims
        elif rerun_sink is not None and len(bad):
            deferred_bad = bad
        elif len(bad):
            ids[bad], sims[bad] = _exact_rows(vecs, sqn, live, qd, bad, k=k)
    if deferred_bad is not None:
        rerun_sink.add((vecs, sqn, live), qd, deferred_bad, ids, sims, k)
    return ids, sims


class CertRerunSink:
    """Coalesces certified-scan fallback reruns across a serving loop.

    Each registered batch contributes its uncertified rows; ``flush``
    serves the union in ONE exact batch and splices the rows back into
    the already-returned (ids, sims) arrays in place. Callers MUST flush
    before reading the replies (ops/search.py flushes after the chunk
    loop, before assembly)."""

    def __init__(self) -> None:
        self._tables = None
        self._items: list = []

    def add(self, tables, qd, bad, ids, sims, k: int) -> None:
        if self._tables is None:
            self._tables = tables
        self._items.append((qd, np.asarray(bad), ids, sims, int(k)))

    def flush(self) -> None:
        if not self._items:
            return
        k = self._items[0][4]
        q_bad = torch.cat([
            qd[torch.from_numpy(bad).to(qd.device)]
            for qd, bad, _ids, _sims, _k in self._items
        ])
        vecs, sqn, live = self._tables
        all_ids, all_sims = _exact_rows(
            vecs, sqn, live, q_bad, np.arange(len(q_bad)), k=k
        )
        lo = 0
        for _qd, bad, ids, sims, kk in self._items:
            nb = len(bad)
            ids[bad] = all_ids[lo : lo + nb, :kk]
            sims[bad] = all_sims[lo : lo + nb, :kk]
            lo += nb
        self._items.clear()
        self._tables = None


# -- ids-only replies (host exact rescore) ------------------------------------
#
# REDIS_HNSW_TPU_REPLY=ids copies ONLY the [B, k] id block off the card
# and recomputes the k sims on the host in exact direct form, from the
# f32 rows the host already holds (index._vectors), when the caller has
# the queries on the host for free (numpy input, or a ``host_qs``
# mirror). The host sums in the card's order, so the reply equals the
# full reply bit for bit; it is re-sorted by (-sim, id) all the same.
# Hamming replies are integer distances and never take this path.
#
# The mode pays only where the reply's bytes, not the host rescore,
# dominate, so "ids" is guarded: it engages iff the sims bytes it saves
# are estimated to cost more than the host rescore,
#
#   saved   = (n_q * k * 4 bytes of sims) * d2h_sec_per_byte
#   rescore = (n_q * k * dim elements)    * host_sec_per_elem
#
# n_q * k cancels: engage iff 4 * d2h_sec_per_byte > dim *
# host_sec_per_elem. Both slopes are calibrated once per process and
# device: d2h_sec_per_byte is the MARGINAL copy cost (the slope between
# a 64 KB and a 4 MB copy, so the fixed per-copy latency cancels). A CPU
# index copies nothing, so its slope is ~0 and the guard turns ``ids``
# off there. REDIS_HNSW_TPU_REPLY=ids-force skips the guard (tests pin
# the path with it).

_IDS_GUARD: dict = {}  # ("cal", device): slopes; (device, dim): verdict


def reply_ids_only() -> bool:
    """Does REDIS_HNSW_TPU_REPLY ask for ids-only replies ("ids" or
    "ids-force"; "full" is the default)? Raises on any other value."""
    v = os.environ.get("REDIS_HNSW_TPU_REPLY", "full")
    if v not in ("full", "ids", "ids-force"):
        raise ValueError(f"REDIS_HNSW_TPU_REPLY={v!r}")
    return v != "full"


def _ids_guard_calibrate(device) -> tuple[float, float]:
    """(d2h_sec_per_byte, host_sec_per_elem) on ``device``, measured once
    per process: the best of three copies to the host of a fresh 64 KB
    and a fresh 4 MB int32 tensor (the card synchronized before each
    clock starts), and one host rescore of a [1024, 10, 128] block."""
    import time

    key = ("cal", str(device))
    if key in _IDS_GUARD:
        return _IDS_GUARD[key]
    device = torch.device(device)
    base_s = torch.zeros((2048, 8), dtype=torch.int32, device=device)
    base_b = torch.zeros((2048, 512), dtype=torch.int32, device=device)

    def best_d2h(base) -> float:
        best = float("inf")
        for i in range(1, 4):
            a = base + i  # a fresh tensor each rep
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            a.cpu()
            best = min(best, time.perf_counter() - t0)
        return best

    (base_s + 0).cpu()  # warm the copy path
    (base_b + 0).cpu()
    nbytes = (base_b.numel() - base_s.numel()) * 4
    spb = max((best_d2h(base_b) - best_d2h(base_s)) / nbytes, 0.0)
    v = np.random.default_rng(0).standard_normal(
        (1024, 10, 128)
    ).astype(np.float32)
    q = np.zeros((1024, 128), np.float32)
    t0 = time.perf_counter()
    neg_sq_rows(v, q)
    spe = (time.perf_counter() - t0) / v.size
    _IDS_GUARD[key] = (spb, spe)
    return spb, spe


def reply_ids_engaged(dim: int, device) -> bool:
    """Should a reply over ``device`` use the ids-only copy and the host
    rescore? False unless REDIS_HNSW_TPU_REPLY opts in; "ids" is
    guarded by the calibrated estimate above, "ids-force" is
    unconditional."""
    v = os.environ.get("REDIS_HNSW_TPU_REPLY", "full")
    if v not in ("full", "ids", "ids-force"):
        raise ValueError(f"REDIS_HNSW_TPU_REPLY={v!r}")
    if v == "full":
        return False
    if v == "ids-force":
        return True
    key = (str(device), int(dim))
    verdict = _IDS_GUARD.get(key)
    if verdict is None:
        spb, spe = _ids_guard_calibrate(device)
        verdict = 4.0 * spb > dim * spe
        _IDS_GUARD[key] = verdict
        if not verdict:
            import logging

            logging.getLogger("redis_hnsw_tpu_torch").warning(
                "REDIS_HNSW_TPU_REPLY=ids auto-disabled at dim=%d on %s: "
                "est. host rescore %.1f ns/result-row > est. bytes saved "
                "%.1f ns/result-row (marginal D2H %.3g s/byte, host "
                "rescore %.3g s/elem). Use REDIS_HNSW_TPU_REPLY=ids-force "
                "to override.",
                dim, device, dim * spe * 1e9, 4.0 * spb * 1e9, spb, spe,
            )
    return verdict


def neg_sq_rows(v, q):
    """-||q - v||^2 of host rows ``v`` [B, k, D] against ``q`` [B, D]
    f32, on the host CPU, summed in ops/distance.py ``_sum_last``'s fixed
    order: elementwise adds only, so the host gives the same bits as the
    card's direct-form rescore (``exact_neg_sq_l2``) and an ids-only
    reply equals the full reply. (The JAX package sums with a library
    reduction here; the two differ in the last ulps, as every
    direct-form sim of the two packages may, ROADMAP.md section 3.)"""
    d = torch.from_numpy(np.ascontiguousarray(v))
    d = d - torch.from_numpy(np.ascontiguousarray(q))[:, None, :]
    return (-D._sum_last(d * d)).numpy()


def host_exact_sims(vecs_host, qs_host, ids):
    """Exact direct-form sims of ``ids`` [B, k] rows vs ``qs_host``
    [B, D], computed on the host from the f32 row table. Invalid ids
    (< 0) get -inf."""
    q = np.atleast_2d(np.asarray(qs_host, np.float32))
    v = vecs_host[np.clip(ids, 0, len(vecs_host) - 1)]
    sims = neg_sq_rows(v, q)
    return np.where(ids >= 0, sims, NEG_INF).astype(np.float32)


def sort_reply(ids, sims):
    """Re-impose the (-sim, id) reply order on the host: the host
    rescore's sums can differ from the card's by ~1 ulp, enough to leave
    a near-tied reply out of order. -inf (invalid) slots stay last."""
    order = np.lexsort((ids, -sims), axis=-1)
    return (
        np.take_along_axis(ids, order, -1),
        np.take_along_axis(sims, order, -1),
    )


# -- host-side engine wrapper -------------------------------------------------

def _scan_state(index, max_staleness: int = 0):
    """Per-epoch device state of the scan: (vecs, sqn, live). Cached on
    the index keyed by the SNAPSHOT epoch -- the epoch the tables hold,
    which lags the index's mutation epoch under bounded-staleness
    serving. With a stale snapshot the live mask is truncated at the
    snapshot's row high-water (``live_hw``) so rows allocated after it
    -- whose vectors the stale table does not hold -- never score. A
    hamming snapshot's ``vecs`` are its packed words (int32), which the
    hamming kernels read as they are; its ``sqn`` are zeros."""
    scan_dtype(index.config.metric)
    snap = index.device_snapshot(max_staleness)
    snap_epoch = index._snapshot_epoch
    cached = getattr(index, "_scan_cache", None)
    if cached is not None and cached[0] == snap_epoch:
        return cached[1]
    live_np = np.zeros(snap.n_pad, bool)
    h = min(len(index._levels), snap.n_pad, snap.live_hw)
    live_np[:h] = index._levels[:h] >= 0
    state = (snap.vecs, snap.sqnorms, torch.from_numpy(live_np).to(index.device))
    index._scan_cache = (snap_epoch, state)
    return state


def pad_queries(qs, n_pad: int, device):
    """Query block as a tensor on ``device``, zero-padded to ``n_pad``
    rows: float32, or int32 for packed hamming words (uint32 words keep
    their bytes, as the snapshot stores them)."""
    if isinstance(qs, torch.Tensor):
        qd = qs
    elif np.asarray(qs).dtype in (np.uint32, np.int32):
        qd = torch.from_numpy(np.ascontiguousarray(qs).view(np.int32))
    else:
        qd = torch.from_numpy(np.ascontiguousarray(qs, np.float32))
    dtype = torch.int32 if qd.dtype == torch.int32 else torch.float32
    qd = qd.to(device=device, dtype=dtype)
    if n_pad != qd.shape[0]:
        qd = torch.cat(
            [qd, qd.new_zeros((n_pad - qd.shape[0], qd.shape[1]))]
        )
    return qd


def serve_block(vecs, sqn, live, qd, *, k: int, n_q: int, metric: str,
                rerun_sink=None, approx: bool = False, ids_only=False):
    """Serve the (padded) query block ``qd`` on the tier its table takes:
    a hamming table the exact tier (kernel A′); a euclidean table the
    certified tier where ``cert_enabled`` admits it and ``approx`` is
    off, else the exact tier. Returns the ``(ids, sims)`` numpy reply of
    the first ``n_q`` queries; ``rerun_sink`` defers the certified
    tier's fallback reruns.

    ``approx`` is the scan-approx tier. The JAX package selects it with
    ``jax.lax.approx_max_k`` at k_sel = 4k, which is exact off the TPU;
    here it is kernel A's exact select at k, so its replies are the
    exact tier's (recall 1.0, above APPROX_TIER_FLOOR) and equal the
    JAX package's CPU replies. Selecting 4k would only cost time.

    ``ids_only`` copies only the ids off the card and returns ``(ids,
    None)``; the caller rescores the sims on the host (the ids-reply
    mode). On the certified tier the fallback runs at once and patches
    the sims too, so that tier still copies them."""
    if metric == "hamming":
        ids, sims = scan_topk_exact_hamming(vecs, live, qd, k=k)
    elif not approx and cert_enabled(int(vecs.shape[0]), int(vecs.shape[1])):
        result = scan_certified_l2(vecs, sqn, live, qd, k=k)
        ids, sims = certified_finish(
            vecs, sqn, live, qd, result, k=k, n_q=n_q,
            rerun_sink=None if ids_only else rerun_sink,
        )
        return (ids, None) if ids_only else (ids, sims)
    else:
        ids, sims = scan_topk_exact_l2(vecs, sqn, live, qd, k=k)
    if ids_only:
        return ids[:n_q].cpu().numpy(), None
    return ids[:n_q].cpu().numpy(), sims[:n_q].cpu().numpy()


def scan_dispatch(index, qs, k: int, approx: bool = False, host_qs=None,
                  cert_sink=None, staleness: int = 0):
    """Serve one query batch through the scan; returns the (ids, sims)
    numpy reply. ``approx`` serves the scan-approx tier (see
    :func:`serve_block`). ``cert_sink`` (a :class:`CertRerunSink` the
    caller later flushes) coalesces the certified tier's fallback reruns
    across a chunk loop. ``staleness`` > 0 serves from the bounded-stale
    snapshot view (models/hnsw.py device_snapshot).

    With REDIS_HNSW_TPU_REPLY=ids and the queries on the host (numpy
    ``qs``, or a ``host_qs`` mirror of a device ``qs``), a euclidean
    reply copies only its ids off the card and its sims are recomputed
    on the host (see :func:`reply_ids_engaged`)."""
    vecs, sqn, live = _scan_state(index, max_staleness=staleness)
    metric = index.config.metric
    if host_qs is None and not isinstance(qs, torch.Tensor):
        host_qs = qs
    ids_mode = (
        metric == "euclidean" and host_qs is not None
        and reply_ids_engaged(int(qs.shape[1]), vecs.device)
    )
    n_q = qs.shape[0]
    qd = pad_queries(qs, pad_pow2(n_q), vecs.device)
    ids, sims = serve_block(
        vecs, sqn, live, qd, k=min(int(k), int(vecs.shape[0])), n_q=n_q,
        metric=metric, rerun_sink=cert_sink, approx=approx,
        ids_only=ids_mode,
    )
    if ids_mode:
        return sort_reply(ids, host_exact_sims(index._vectors, host_qs, ids))
    return ids, sims
