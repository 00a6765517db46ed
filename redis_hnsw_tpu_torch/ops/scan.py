"""Exact scan engine: brute-force k-NN over the index snapshot.

Port of ``redis_hnsw_tpu/ops/scan.py``, its TPU-link machinery aside
(parallel/sharded.py serves each shard with the functions here). Below ``ops/search.py``
SCAN_MAX_ROWS the scan serves ``search_batch``: it is
exact (recall 1.0), and a whole query batch against the whole table is
one dense pass that a GPU runs well.

Two tiers, chosen per table by :func:`certified_serves` (the one tier
rule of every caller), which for a euclidean table asks
:func:`cert_enabled`:

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
  byte-compared. Where a table epoch's batches keep falling back whole
  (tie-heavy or cluster-ordered rows), its later batches skip the
  certificate and take the exact tier, all but one in CERT_PROBE_EVERY
  (:class:`CertHistory`).

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

**Hamming** tables are packed bit rows, int32 words. Their exact tier is
kernel A′ (:func:`scan_topk_exact_hamming`): it selects by integer
scores, exact in f32, so its top k needs no rescore; like kernel A, it
serves every k. Their **certified tier** is the JAX package's
(:func:`scan_certified_hamming`): kernel A′ selects ``k_sel = oversample
* k``, kernel B′ (ops/cuda_count_hamming.py) counts the rows above and
at the k-th score t, and the deep certificate is checked against the
WHOLE selection, so a tie class straddling k certifies when it fits in
it; :func:`certified_finish` serves the uncertified queries again on
the exact tier. :func:`hamming_cert_ready` says where it runs:
REDIS_HNSW_TPU_SCAN_CERT=1 serves it wherever the JAX package's two
gates admit the table (the 31-bit word pack and ``cert_enabled`` at
16 * words dims), 0 never. Under ``auto`` (the default) a hamming table
stays on the exact tier, where the JAX package's gates would certify
from 2^19 rows: on the H100 the certified tier served
flat-hamming-sift256 slower than the exact tier (both measured in one
chip_smoke.py call, phase 3b; the numbers are in ROADMAP.md section 3).
Replies carry ``-distance`` with a zero distance as -0.0, as the JAX
package's word-packed reply decodes it.

The **bf16 and int8 tiers** (:func:`scan_dtype`, opt-in) select on a
low-precision copy of the table -- kernel A-bf16 or A-int8
(ops/cuda_scan.py) on the tensor cores -- and rescore the k they select
from the f32 rows in exact direct form, so reported sims stay exact; a
tier table never certifies. The flat index's int8 tier keeps only the
int8 table on the card (:func:`serve_resident_int8`).

The **scan-approx** tier (``approx=True``) is served on the exact tier
(:func:`serve_block`), and REDIS_HNSW_TPU_REPLY=ids copies only a
euclidean reply's ids off the card and rescores its sims on the host
(:func:`reply_ids_engaged`).

**The pipelined serving loop** (:func:`drain_pipelined`) serves every
scan block (ops/search.py ``scan_block`` on one card, a block of one
chunk too) and every multi-chunk graph and sharded block, as in the JAX
package: each serving function is
a dispatch half, which queues a chunk's kernels and registers its reply
tensors with :func:`fetch_handle`, and returns a zero-argument finish
half, which waits for the reply and does the host's part (the int8
tier's rescore, the ids-only rescore, the certified verdict and its
fallback). Up to :func:`pipeline_depth` fetch windows stay dispatched but
unfinished, so the card runs later chunks while the host finishes
earlier ones. A window of :func:`fetch_window` chunks shares one copy to
the host (:class:`FetchGroup`): its replies are concatenated on the card
as bytes and copied into pinned host memory, asynchronously, when the
window closes. The JAX package's packed int32 replies are not ported:
each reply tensor is its own slice of the window's copy.
"""

from __future__ import annotations

import functools
import os
import threading
from collections import deque

import numpy as np
import torch

from ..utils import profiling
from . import distance as D
from .cuda_count import count_gt_eq
from .cuda_count_hamming import count_hamming
from .cuda_scan import (
    CHUNK_N,
    euclid_sq_masked,
    flat_topk,
    flat_topk_bf16,
    flat_topk_hamming,
    flat_topk_int8,
    hamming_bias,
    pad_lowp_rows,
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


def int8_rescore_mult() -> int:
    """Selection width multiplier of the int8-resident flat tier
    (models/flat.py): the card selects ``mult * k`` candidates on the
    quantized table and the host's exact f32 rescore keeps the best k of
    them, buying back recall lost to int8 scoring error.
    REDIS_HNSW_TPU_INT8_RESCORE, default 8, as in the JAX package."""
    v = os.environ.get("REDIS_HNSW_TPU_INT8_RESCORE", "8")
    try:
        return max(1, int(v))
    except ValueError:
        raise ValueError(f"REDIS_HNSW_TPU_INT8_RESCORE={v!r}")


def scan_dtype() -> str:
    """Euclidean scan-table tier, REDIS_HNSW_TPU_SCAN_DTYPE (a hamming
    table ignores it, as in the JAX package):

    * ``f32`` (the default) -- kernel A selects on the f32 table; the
      selection is exactly exact.
    * ``bf16`` -- kernel A-bf16 selects on a bfloat16 copy of the table
      (:func:`_to_bf16`) against bf16 queries: a tensor-core product, half
      the bytes. Selection can differ from f32 only where two rows' scores
      agree to ~3 decimal digits; the selected k are rescored in exact f32
      direct form from the f32 table, so reported sims stay exact.
    * ``int8`` -- kernel A-int8 selects on a per-row symmetric int8 copy
      (:func:`_to_int8`, a quarter of the f32 bytes) against per-row
      quantized queries; the final k are rescored like bf16's. On a flat
      index it is the int8-RESIDENT tier: only the int8 table goes to the
      card (models/flat.py).

    A tier table never serves the certified tier."""
    v = os.environ.get("REDIS_HNSW_TPU_SCAN_DTYPE", "f32")
    if v not in ("f32", "bf16", "int8"):
        raise ValueError(f"REDIS_HNSW_TPU_SCAN_DTYPE={v!r}")
    return v


def _to_bf16(vecs):
    """The bf16 tier's table: ``vecs`` rounded to bfloat16 (to nearest,
    ties to even, as XLA converts)."""
    return vecs.to(torch.bfloat16)


def _to_int8(vecs):
    """Per-row symmetric int8 quantization -> (q8 [N, D] int8, scale [N]
    f32): scale = max|v| / 127 (1 on an all-zero row, so the descale stays
    finite), q8 = round(v / scale) half to even, clipped to +-127. The
    JAX package's ``_to_int8`` byte for byte (ops/distance.py
    ``quantize_query``, whose scale multiplies by 1/127 as XLA compiles
    the JAX package's division by the constant)."""
    return D.quantize_query(vecs)


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
              metric: str = "euclidean", table=None, tscale=None):
    """Top-k of every query against every live row.

    ``vecs`` [N, D] f32 (= snapshot vecs) with ``sqn`` [N] row sqnorms,
    scored in matmul form by kernel A; or, with ``metric="hamming"``,
    [N, W] int32 packed bits scored by kernel A′ (``sqn`` unused).
    ``table`` selects on a tier's copy instead (``vecs`` is then unused):
    a bf16 table scored by kernel A-bf16 against the queries cast to
    bf16, or an int8 table with its per-row ``tscale`` scored by kernel
    A-int8 against the queries quantized by :func:`_to_int8`; ``qq`` is
    the f32 queries' sqnorm and ``sqn`` the f32 rows' either way, as in
    the JAX package. ``live`` [N] bool masks real, undeleted rows. The
    kernel selects ``k_sel`` (default ``k``) rows and the best ``k`` are
    kept. Returns (ids, sims) sorted descending by (sim, -id) -- the
    kernels' own order -- with -1/-inf in empty slots. Every kernel
    serves every k.
    """
    k_sel = k if k_sel is None else max(int(k_sel), k)
    if metric == "hamming":
        ids, sims = flat_topk_hamming(
            queries, vecs, hamming_bias(live), k=k_sel
        )
    else:
        sq, qq = euclid_sq_masked(sqn, live), D.sqnorms(queries)
        if table is None:
            ids, sims = flat_topk(queries, vecs, sq, qq, k=k_sel)
        elif tscale is None:
            ids, sims = flat_topk_bf16(
                queries.to(table.dtype), table, sq, qq, k=k_sel
            )
        else:
            q8, qscale = _to_int8(queries)
            ids, sims = flat_topk_int8(
                q8, qscale, table, tscale, sq, qq, k=k_sel
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
                       k_sel: int | None = None, table=None, tscale=None):
    """Euclidean scan + exact direct-form rescore of the final k (the
    matmul form loses ~1e-3 relative to cancellation; reported sims
    must match the reference kernel to f32 rounding, metrics.rs:79-84),
    re-sorted by ``(-sim, id)``. ``table`` / ``tscale`` select on a bf16
    or int8 tier's copy (:func:`scan_topk`); the rescore always reads the
    f32 ``vecs``."""
    ids, sims = scan_topk(vecs, sqn, live, queries, k=k, k_sel=k_sel,
                          table=table, tscale=tscale)
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
# certified path, and how many queries needed the exact fallback
# (``fallback_queries``, the uncertified ones). The exact tier served
# again, apart: ``whole_batch_queries``, the queries of batches rerun
# whole because more than a quarter were uncertified;
# ``rerun_queries``, uncertified queries rerun by themselves (deferred to
# a rerun sink, or at once); ``audit_queries``, the queries of audited
# batches (CERT_AUDIT_EVERY). The open request's record counts the last
# three and ``cert_queries`` (utils/profiling.py). ``skipped_queries``:
# the queries of batches the certified tier would have served but a
# failing history (:class:`CertHistory`) sent straight to the exact tier;
# they count in no other key (not in ``batches`` or ``queries``), and the
# record counts them as ``cert_skipped_queries``.
CERT_STATS = {"batches": 0, "queries": 0, "fallback_queries": 0,
              "whole_batch_queries": 0, "rerun_queries": 0,
              "audit_queries": 0, "skipped_queries": 0}


def count_certified(n_q: int) -> None:
    """Count a batch of ``n_q`` queries served by a certified tier."""
    CERT_STATS["batches"] += 1
    CERT_STATS["queries"] += n_q
    profiling.count("cert_queries", n_q)


def count_rerun(key: str, n: int) -> None:
    """Count ``n`` queries served again on the exact tier, under
    CERT_STATS ``key`` and the open request's field of that name."""
    CERT_STATS[key] += n
    profiling.count(key, n)


def count_skipped(n_q: int) -> None:
    """Count a batch of ``n_q`` queries that a failing certified tier left
    to the exact tier (:class:`CertHistory`)."""
    CERT_STATS["skipped_queries"] += n_q
    profiling.count("cert_skipped_queries", n_q)


# While a table epoch's certificate keeps failing, one batch in
# CERT_PROBE_EVERY still takes the certified tier (the probe) and the rest
# go straight to the exact tier. 16 keeps kernel D launching several
# times in every few seconds of a failing table's traffic (~3 batches a
# 5,000-query request: a probe every ~5 requests), so its time and
# roofline stay observable, while the probes' second pass reaches few
# enough requests to leave the latency tail to the others.
CERT_PROBE_EVERY = 16


class CertHistory:
    """The certified tier's fallback history of one table epoch.

    A batch that :func:`certified_finish` serves again whole (more than a
    quarter uncertified, ``whole_batch_queries``) marks the history
    failing; a certified batch that is not served again whole clears it
    (audits and per-query reruns are no failures), so the newest verdict
    decides. While it fails, :meth:`certify` sends all but one batch in
    CERT_PROBE_EVERY straight to the exact tier, which the whole-batch
    fallback would have served them on anyway after a wasted certified
    pass; the probe's verdict keeps the history or clears it.

    One history belongs to one epoch's tables (:class:`ScanState`), so an
    insert or a delete, which starts the next epoch, starts it clean. The
    sharded index keeps no history: it certifies every batch."""

    __slots__ = ("failing", "waited")

    def __init__(self) -> None:
        self.failing = False
        self.waited = 0  # batches sent to the exact tier since the last probe

    def certify(self) -> bool:
        """Should the next batch take the certified tier? Always while the
        history is clean; while it fails, every CERT_PROBE_EVERY-th."""
        if not self.failing:
            return True
        self.waited += 1
        if self.waited < CERT_PROBE_EVERY:
            return False
        self.waited = 0
        return True

    def record(self, key) -> None:
        """Record a certified batch's fallback (:func:`cert_fallback`'s
        ``key``)."""
        self.failing = key == "whole_batch_queries"
        if not self.failing:
            self.waited = 0


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


def hamming_cert_enabled(n_rows: int, words: int) -> bool:
    """Should the certified hamming tier serve an ``n_rows`` table of
    ``words`` packed 32-bit words? REDIS_HNSW_TPU_SCAN_CERT=1 and 0 as
    :func:`cert_enabled` at the JAX package's dim gate, ``16 * words``
    (the count pass's int8 product). ``auto`` never: on the H100 the
    certified tier loses to the exact tier where the JAX package's gates
    would engage it (module docstring), so a hamming table stays on the
    exact tier by default. The sharded index uses this gate alone (its
    reply is not word-packed, as in the JAX package)."""
    if os.environ.get("REDIS_HNSW_TPU_SCAN_CERT", "auto") == "auto":
        return False
    return cert_enabled(int(n_rows), 16 * int(words))


def hamming_cert_ready(n_rows: int, words: int) -> bool:
    """True iff the certified hamming tier will serve an ``n_rows`` table
    of ``words`` packed 32-bit words on one index (the scan route and the
    flat index): the JAX package's two gates -- its word-packed reply
    ``(dist << id_bits) | id`` must fit 31 bits, and
    :func:`hamming_cert_enabled`. The port packs no words, but keeps the
    pack gate so that the same tables take the same tier."""
    d_bits = 32 * int(words)
    id_bits = max((int(n_rows) - 1).bit_length(), 1)
    if d_bits.bit_length() + id_bits > 31:
        return False
    return hamming_cert_enabled(n_rows, words)


def certified_serves(metric: str, n_rows: int, width: int, *,
                     approx: bool = False, tiered: bool = False,
                     word_pack: bool = True) -> bool:
    """The tier rule of every scan: does a block on an ``n_rows`` x
    ``width`` table take a certified tier? Never on the approx tier. A
    euclidean table where :func:`cert_enabled` admits it and it does not
    select on a bf16 or int8 copy (``tiered``); a hamming table of
    ``width`` words where :func:`hamming_cert_ready` does, or with
    ``word_pack=False`` (the sharded index) :func:`hamming_cert_enabled`."""
    if approx:
        return False
    if metric == "hamming":
        if word_pack:
            return hamming_cert_ready(n_rows, width)
        return hamming_cert_enabled(n_rows, width)
    return not tiered and cert_enabled(n_rows, width)


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


def _exact_rows(exact, qd, rows, *, k: int):
    """Exact-tier reply of the query rows ``rows`` of ``qd``, served by
    ``exact`` (see :func:`certified_finish`) in one pow2-padded batch
    (numpy ids, sims)."""
    nb = len(rows)
    sel = np.zeros(pad_pow2(nb), np.int64)
    sel[:nb] = rows
    ids, sims = exact(qd[torch.from_numpy(sel).to(qd.device)], k=k)
    with profiling.span("card_wait"):
        return ids[:nb].cpu().numpy(), sims[:nb].cpu().numpy()


def cert_fallback(ok, n_q: int, *, audits: bool = False):
    """The certified tier's fallback rule over a batch of ``n_q`` queries
    and its numpy bool verdicts ``ok``, with its counts. Returns ``(key,
    bad)``: ``bad`` the uncertified rows; ``key`` None (nothing to serve
    again), ``"rerun_queries"`` (the rows ``bad``), or the whole batch --
    ``"audit_queries"`` on every CERT_AUDIT_EVERY-th certified batch where
    the caller ``audits``, else ``"whole_batch_queries"`` where more than
    a quarter are uncertified (tie-heavy data, where one whole rerun
    beats many small ones)."""
    count_certified(n_q)
    audit = (
        audits and CERT_AUDIT_EVERY > 0
        and CERT_STATS["batches"] % CERT_AUDIT_EVERY == 0
    )
    if ok.all() and not audit:
        return None, None
    bad = np.flatnonzero(~ok)
    CERT_STATS["fallback_queries"] += len(bad)
    if audit or len(bad) * 4 > n_q:
        key = "audit_queries" if audit else "whole_batch_queries"
        count_rerun(key, n_q)
    else:
        key = "rerun_queries"
        count_rerun(key, len(bad))
    return key, bad


def certified_finish(exact, qd, fetch, *, k: int, n_q: int,
                     rerun_sink=None, history=None):
    """Finish half of a certified tier: fetch the reply and the verdicts
    of a :func:`scan_certified_l2` (or :func:`scan_certified_hamming`)
    result, then re-serve the uncertified queries through the exact tier.

    ``exact(q, k=k) -> (ids, sims)`` is the table's exact tier on a
    device query block (:func:`serve_block` binds
    :func:`scan_topk_exact_l2` or :func:`scan_topk_exact_hamming` to the
    table). ``fetch`` is a zero-arg getter of the result's first ``n_q``
    rows, ``(ids, sims, ok)`` as writable numpy arrays, ok as uint8
    (:func:`serve_block` registers them with :func:`fetch_handle`, so a
    drain's window copies them with its other replies).

    ``rerun_sink`` (a :class:`CertRerunSink`) defers the fallback rerun:
    uncertified rows are registered with the sink and patched when the
    caller flushes it, so a multi-batch loop serves them all in one
    exact batch. Audit batches and the whole-batch fallback stay
    immediate. The choice and its counts are :func:`cert_fallback`'s;
    ``history`` (the table epoch's :class:`CertHistory`) records it."""
    ids, sims, okh = fetch()
    okh = okh != 0
    key, bad = cert_fallback(okh, n_q, audits=True)
    if history is not None:
        history.record(key)
    if key == "rerun_queries":
        if rerun_sink is not None:
            rerun_sink.add(exact, qd, bad, ids, sims, k)
        else:
            ids[bad], sims[bad] = _exact_rows(exact, qd, bad, k=k)
    elif key is not None:
        f_ids, f_sims = exact(qd, k=k)
        with profiling.span("card_wait"):
            f_ids = f_ids[:n_q].cpu().numpy()
            f_sims = f_sims[:n_q].cpu().numpy()
        if key == "audit_queries":
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
    return ids, sims


class CertRerunSink:
    """Coalesces certified-scan fallback reruns across a serving loop.

    Each registered batch contributes its uncertified rows; ``flush``
    serves the union in ONE exact batch and splices the rows back into
    the already-returned (ids, sims) arrays in place. Callers MUST flush
    before reading the replies (ops/search.py flushes after the chunk
    loop, before assembly)."""

    def __init__(self) -> None:
        self._exact = None
        self._items: list = []

    def add(self, exact, qd, bad, ids, sims, k: int) -> None:
        """Register ``bad`` rows of ``qd``; ``exact`` is the table's exact
        tier (:func:`certified_finish`). One sink serves one table, so the
        first registration's ``exact`` serves the flush."""
        if self._exact is None:
            self._exact = exact
        self._items.append((qd, np.asarray(bad), ids, sims, int(k)))

    def flush(self) -> None:
        if not self._items:
            return
        k = self._items[0][4]
        q_bad = torch.cat([
            qd[torch.from_numpy(bad).to(qd.device)]
            for qd, bad, _ids, _sims, _k in self._items
        ])
        all_ids, all_sims = _exact_rows(
            self._exact, q_bad, np.arange(len(q_bad)), k=k
        )
        lo = 0
        for _qd, bad, ids, sims, kk in self._items:
            nb = len(bad)
            ids[bad] = all_ids[lo : lo + nb, :kk]
            sims[bad] = all_sims[lo : lo + nb, :kk]
            lo += nb
        self._items.clear()
        self._exact = None


# -- certified-exact hamming (deep certificate) --------------------------------
#
# The euclidean certificate's counting proof, with the JAX package's two
# hamming twists: the tie counts are checked against the ENTIRE oversampled
# selection (integer distances tie so heavily that the k-th tie class
# almost always straddles k; the deep check certifies whenever the class
# fits in the selection), and the scores are small integers, exact in
# f32, so the select (kernel A′) and the count (kernel B′) agree by
# arithmetic. Kernel A′'s selection is exact where the JAX package's is
# ``approx_max_k``: here the certificate refuses only tie classes larger
# than the selection, and the port's verdicts equal the JAX package's on
# the CPU, where its select is exact too.


def scan_certified_hamming(words, live, queries, *, k: int):
    """Kernel A′'s selection at the JAX package's ``k_sel =
    min(scan_oversample() * k, n_chunk)`` (n_chunk = min(CHUNK_N, N)),
    kept whole and (-sim, id)-sorted, then the deep certificate: with t
    the k-th selected score, kernel B′ counts c_gt and c_eq over the whole
    table, s_gt and s_eq count the selection, and

        ok = (c_gt == s_gt) & ((t == -inf) | (c_eq == s_eq))

    (at t = -inf, c_gt == s_gt asserts every live row was selected; the
    tie count is escaped there, where c_eq counts dead rows). Returns
    ``(ids, sims, ok)`` device tensors: the selection's first k with the
    reply's sims (:func:`hamming_reply_sims`) and the [B] verdicts --
    True means the first k are the exact tier's reply, tie membership
    included. ``scan_topk`` is looked up at call time so tests can
    truncate the selection."""
    N = int(words.shape[0])
    k_sel = min(scan_oversample() * k, min(CHUNK_N, N))
    sel_ids, sel_sims = scan_topk(words, None, live, queries, k=k_sel,
                                  metric="hamming")
    t = sel_sims[:, k - 1].contiguous()
    s_gt = (sel_sims > t[:, None]).sum(dim=1, dtype=torch.int32)
    s_eq = (sel_sims == t[:, None]).sum(dim=1, dtype=torch.int32)
    c_gt, c_eq = count_hamming(queries, words, hamming_bias(live), t)
    ok = (c_gt == s_gt) & ((t == NEG_INF) | (c_eq == s_eq))
    return sel_ids[:, :k], hamming_reply_sims(sel_sims[:, :k]), ok


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
    d = torch.as_tensor(v)
    d = d - torch.from_numpy(np.ascontiguousarray(q))[:, None, :]
    return (-D._sum_last(d * d)).numpy()


def host_exact_sims(vecs_host, qs_host, ids):
    """Exact direct-form sims of ``ids`` [B, k] rows vs ``qs_host``
    [B, D], computed on the host from the f32 row table (its rows
    gathered by torch's ``index_select``, which runs on several threads
    where numpy's fancy index runs on one). Invalid ids (< 0) get -inf."""
    q = np.atleast_2d(np.asarray(qs_host, np.float32))
    rows = np.clip(ids, 0, len(vecs_host) - 1).astype(np.int64).ravel()
    v = torch.from_numpy(np.ascontiguousarray(vecs_host)).index_select(
        0, torch.from_numpy(rows)).view(*ids.shape, vecs_host.shape[1])
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

class ScanState(tuple):
    """One table epoch's scan state, the tuple ``(table, vecs, sqn, live,
    tscale)`` (:func:`_scan_state`, models/flat.py ``scan_state``), with
    that epoch's :class:`CertHistory` as ``cert_history``. The history
    rides on the state, which :func:`serve_chunk` hands to
    :func:`serve_block`, because the state is what each epoch builds
    anew: the history starts clean with the tables, and goes with them."""

    def __new__(cls, table, vecs, sqn, live, tscale):
        state = super().__new__(cls, (table, vecs, sqn, live, tscale))
        state.cert_history = CertHistory()
        return state


def _scan_state(index, max_staleness: int = 0):
    """Per-epoch device state of the scan, a :class:`ScanState`: (table,
    vecs, sqn, live, tscale). ``table`` is the selection table --
    ``vecs`` itself, or the bf16 or int8 tier's copy (:func:`scan_dtype`),
    built on the card from the snapshot with its rows padded to 4 bytes
    -- ``vecs`` the f32 rows the rescore reads, ``tscale`` the int8
    tier's per-row scales (None otherwise). A hamming snapshot's ``vecs``
    are its packed words (int32), which the hamming kernels read as they
    are, and its table; its ``sqn`` are zeros.

    Cached on the index keyed by (SNAPSHOT epoch, tier): the epoch the
    tables hold, which lags the index's mutation epoch under
    bounded-staleness serving, and the tier, so a switch of tiers at the
    same epoch rebuilds the tables. With a stale snapshot the live mask
    is truncated at the snapshot's row high-water (``live_hw``) so rows
    allocated after it -- whose vectors the stale table does not hold --
    never score."""
    dt = scan_dtype() if index.config.metric == "euclidean" else "f32"
    snap = index.device_snapshot(max_staleness)
    key = (index._snapshot_epoch, dt)
    cached = getattr(index, "_scan_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    index._scan_cache = None  # free the old tables before building
    live_np = np.zeros(snap.n_pad, bool)
    h = min(len(index._levels), snap.n_pad, snap.live_hw)
    live_np[:h] = index._levels[:h] >= 0
    live = torch.from_numpy(live_np).to(index.device)
    table, tscale = snap.vecs, None
    if dt == "bf16":
        table = pad_lowp_rows(_to_bf16(snap.vecs))
    elif dt == "int8":
        table, tscale = _to_int8(snap.vecs)
        table = pad_lowp_rows(table)
    state = ScanState(table, snap.vecs, snap.sqnorms, live, tscale)
    index._scan_cache = (key, state)
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
                rerun_sink=None, approx: bool = False, ids_only=False,
                table=None, tscale=None, cert_history=None):
    """Dispatch half: queue the kernels that serve the (padded) query
    block ``qd`` on the tier its table takes -- the certified tier where
    :func:`certified_serves` says so (kernels A′ and B′ on a hamming
    table; kernel D, or A and B, on a euclidean one), else the exact
    tier: kernel A′ on a hamming table, kernel A on a euclidean one, or
    kernel A-bf16 or A-int8 selecting on a tier ``table`` (with
    ``tscale`` for int8) and rescoring from ``vecs`` -- and register the
    reply with :func:`fetch_handle`. Returns ``finish()``, which gives
    the ``(ids, sims)`` numpy reply of the first ``n_q`` queries;
    ``rerun_sink`` defers the certified tier's fallback reruns. Nothing
    here waits for the card.

    ``approx`` is the scan-approx tier. The JAX package selects it with
    ``jax.lax.approx_max_k`` at k_sel = 4k, which is exact off the TPU;
    here it is the tier's exact select at k (kernel A's, or a bf16 or
    int8 table's), so its replies are the exact select's (for f32,
    recall 1.0, above APPROX_TIER_FLOOR) and equal the JAX package's CPU
    replies. Selecting 4k would only cost time.

    ``ids_only`` copies only the ids off the card and finishes with
    ``(ids, None)``; the caller rescores the sims on the host (the
    ids-reply mode). On the certified tier the fallback runs at once and
    patches the sims too, so that tier still copies them.

    ``cert_history`` is the table epoch's :class:`CertHistory`. Where it
    says the certificate keeps failing, a block the certified tier would
    take is served on the exact tier instead -- the call the whole-batch
    fallback makes, on the same ``qd`` at the same ``k``, so the same
    reply -- and counted as skipped (:func:`count_skipped`); one block in
    CERT_PROBE_EVERY still takes the certified tier, and its finish
    records the verdict.

    Where the exact or approx tier serves the block on kernel A or A′
    alone, the open request's record counts its ``n_q`` queries as
    ``exact_queries`` (utils/profiling.py)."""
    certified = certified_serves(metric, int(vecs.shape[0]),
                                 int(vecs.shape[1]), approx=approx,
                                 tiered=table is not None)
    if certified and (cert_history is None or cert_history.certify()):
        # the table's exact tier serves the uncertified queries again (on
        # a hamming table the audit checks the plumbing: integer scores
        # leave no rounding to audit)
        if metric == "hamming":
            ids, sims, ok = scan_certified_hamming(vecs, live, qd, k=k)
            exact = functools.partial(scan_topk_exact_hamming, vecs, live)
        else:
            ids, sims, ok = scan_certified_l2(vecs, sqn, live, qd, k=k)
            exact = functools.partial(scan_topk_exact_l2, vecs, sqn, live)
        gets = [fetch_handle(t[:n_q])
                for t in (ids, sims, ok.to(torch.uint8))]
        sink = None if ids_only else rerun_sink

        def finish_cert():
            ids, sims = certified_finish(
                exact, qd, lambda: [g() for g in gets], k=k, n_q=n_q,
                rerun_sink=sink, history=cert_history,
            )
            return (ids, None) if ids_only else (ids, sims)

        return finish_cert
    if certified:
        count_skipped(n_q)
    elif table is None:
        profiling.count("exact_queries", n_q)
    if metric == "hamming":
        ids, sims = scan_topk_exact_hamming(vecs, live, qd, k=k)
    else:
        ids, sims = scan_topk_exact_l2(vecs, sqn, live, qd, k=k,
                                       table=table, tscale=tscale)
    get_ids = fetch_handle(ids[:n_q])
    get_sims = None if ids_only else fetch_handle(sims[:n_q])
    return lambda: (get_ids(), None if get_sims is None else get_sims())


def serve_resident_int8(q8, sqn, live, tscale, qd, host_vecs, host_qs, *,
                        k: int, n_q: int):
    """Dispatch half of the int8-resident flat tier (models/flat.py):
    kernel A-int8 selects ``min(int8_rescore_mult() * k, N)`` candidates
    on the card's int8 table and only their ids are registered with
    :func:`fetch_handle`. The returned ``finish()`` rescores every
    candidate exactly on the host from the f32 rows ``host_vecs`` against
    the host queries ``host_qs`` [n_q, D] and keeps the best k in
    ``(-sim, id)`` order: the numpy (ids, sims) [n_q, k]."""
    k_dev = min(int8_rescore_mult() * k, int(q8.shape[0]))
    ids, _ = scan_topk(None, sqn, live, qd, k=k_dev, table=q8,
                       tscale=tscale)
    get_ids = fetch_handle(ids[:n_q])

    def finish_int8():
        ids = get_ids()
        ids, sims = sort_reply(ids, host_exact_sims(host_vecs, host_qs, ids))
        return ids[:, :k], sims[:, :k]

    return finish_int8


def scan_dispatch(index, qs, k: int, approx: bool = False, host_qs=None,
                  cert_sink=None, staleness: int = 0):
    """Queue one query batch of an HNSW index through the scan, the JAX
    package's entry point (:func:`serve_chunk` on its scan state); returns
    a zero-arg ``finish()`` that gives the (ids, sims) numpy reply.
    Nothing here waits for the card when ``qs`` is already on it.
    ``cert_sink`` (a :class:`CertRerunSink` the caller later flushes)
    defers the certified tier's fallback reruns; ``staleness`` > 0 serves
    from the bounded-stale snapshot view. With the queries on the host
    (numpy ``qs``, or a ``host_qs`` mirror) a euclidean reply may copy
    only its ids (:func:`ids_reply_engaged`)."""
    state = _scan_state(index, max_staleness=staleness)
    metric = index.config.metric
    if host_qs is None and not isinstance(qs, torch.Tensor):
        host_qs = qs
    return serve_chunk(
        state, qs, host_qs, k=min(int(k), int(state[0].shape[0])),
        metric=metric, approx=approx, rerun_sink=cert_sink,
        ids_reply=ids_reply_engaged(metric, host_qs, int(qs.shape[1]),
                                    state[0].device),
        host_vecs=index._vectors,
    )


def ids_reply_engaged(metric: str, host_qs, dim: int, device) -> bool:
    """Does a reply copy only its ids off ``device`` and rescore its sims
    on the host? A euclidean one with its queries on the host, where
    :func:`reply_ids_engaged` says so."""
    return (metric == "euclidean" and host_qs is not None
            and reply_ids_engaged(dim, device))


def serve_chunk(state, qs, host_qs=None, *, k: int, metric: str,
                approx: bool = False, rerun_sink=None,
                ids_reply: bool = False, host_vecs=None):
    """Dispatch half of one chunk ``qs`` (numpy, or on the card) over a
    :class:`ScanState` ``(table, vecs, sqn, live, tscale)``
    (:func:`_scan_state`, models/flat.py ``scan_state``), padded to a
    power of two: :func:`serve_resident_int8` where ``vecs`` is None (the
    flat index's int8-resident tier), else :func:`serve_block`, with the
    state's certified fallback history. The resident tier and
    the ids-only reply (``ids_reply``) rescore on the host, from its f32
    rows ``host_vecs`` against the chunk's host queries ``host_qs``.
    Returns ``finish()``, which gives the (ids, sims) numpy reply."""
    table, vecs, sqn, live, tscale = state
    n_q = int(qs.shape[0])
    qd = pad_queries(qs, pad_pow2(n_q), table.device)
    if vecs is None:
        return serve_resident_int8(table, sqn, live, tscale, qd, host_vecs,
                                   host_qs, k=k, n_q=n_q)
    fin = serve_block(
        vecs, sqn, live, qd, k=k, n_q=n_q, metric=metric,
        rerun_sink=rerun_sink, approx=approx, ids_only=ids_reply,
        table=None if table is vecs else table, tscale=tscale,
        cert_history=state.cert_history,
    )
    if not ids_reply:
        return fin

    def finish_ids():
        ids, _ = fin()
        return sort_reply(ids, host_exact_sims(host_vecs, host_qs, ids))

    return finish_ids


def scan_batch(index, qs, k: int, approx: bool = False, host_qs=None):
    """Batched k-NN through the scan engine, the one-call form of
    :func:`scan_dispatch`: one dispatch and its finish."""
    return scan_dispatch(index, qs, k, approx=approx, host_qs=host_qs)()


# -- the pipelined serving loop -----------------------------------------------

def pipeline_depth() -> int:
    """REDIS_HNSW_TPU_PIPELINE: how many fetch windows a multi-chunk
    serving loop keeps dispatched but not finished (default 2, as in the
    JAX package; 0 serializes every chunk, a negative value is 0, an
    empty value takes the default). The card runs the queued chunks
    while the host finishes earlier ones."""
    return max(
        0, int(os.environ.get("REDIS_HNSW_TPU_PIPELINE") or "2")
    )


# The JAX package's default window for the cheap-select tiers (certified
# and approx), where it measured a win; callers pass it there and 1
# elsewhere, and REDIS_HNSW_TPU_FETCH_WINDOW always overrides.
FETCH_WINDOW_FAST = 8


def fetch_window(default: int = 1) -> int:
    """REDIS_HNSW_TPU_FETCH_WINDOW: how many chunks' replies share ONE
    copy to the host in a multi-chunk serving loop (:class:`FetchGroup`).
    Unset, empty or not a number: the caller's ``default``; below 1: 1."""
    v = os.environ.get("REDIS_HNSW_TPU_FETCH_WINDOW")
    if not v:
        return max(1, int(default))
    try:
        return max(1, int(v))
    except ValueError:
        return max(1, int(default))


# The ambient FetchGroup stack: drain_pipelined pushes its open window's
# group around each dispatch call, and fetch_handle() inside a dispatch
# half registers with the innermost group. Thread-local: api.py's
# per-index locks let search_batch run on several indexes at once, and a
# shared stack would let one thread's reply join another's window.
class _ActiveGroups(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_ACTIVE_GROUPS = _ActiveGroups()


class _PinnedPool:
    """Page-locked host buffers for the windows' copies, kept for reuse
    by size (a power of two, at least 4 KiB): pinning costs milliseconds
    a buffer, a copy into one overlaps the card's work. At most KEEP
    free buffers of a size are kept (a drain at depth 2 holds three
    windows)."""

    KEEP = 4

    def __init__(self) -> None:
        self._free: dict = {}
        self._lock = threading.Lock()

    def take(self, nbytes: int):
        size = max(1 << 12, 1 << max(nbytes - 1, 0).bit_length())
        with self._lock:
            free = self._free.get(size)
            if free:
                return free.pop()
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def give(self, buf) -> None:
        with self._lock:
            free = self._free.setdefault(buf.numel(), [])
            if len(free) < self.KEEP:
                free.append(buf)


_PINNED = _PinnedPool()


_NP_DTYPES = {
    torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64,
}


def _np_dtype(dtype):
    """The numpy dtype of a torch dtype a window may carry; bool (as in
    the JAX package) and types numpy lacks (bfloat16) are refused."""
    if dtype == torch.bool:
        raise TypeError("FetchGroup: bitcast of bool replies")
    if dtype not in _NP_DTYPES:
        raise TypeError(f"FetchGroup: no numpy type for {dtype}")
    return _NP_DTYPES[dtype]


class FetchGroup:
    """Coalesces a window's reply tensors into ONE copy to the host.

    Dispatch halves register their reply tensors with
    :func:`fetch_handle` (:meth:`add`). When the window closes,
    :meth:`launch` queues the copy: every tensor is viewed as flat bytes,
    the views of each device are concatenated on it, the blob is copied
    with ``non_blocking=True`` into a pinned host buffer and a CUDA
    event is recorded behind the copy. :meth:`materialize` waits on the
    event and hands each tensor back as a WRITABLE numpy array (the
    certified tier splices fallback rows into its reply in place). The
    group holds the source tensors and the blob until then, so the
    caching allocator cannot hand their memory out while the copy is in
    flight. On the CPU the same code runs with plain copies and no
    event."""

    def __init__(self) -> None:
        self._parts: list = []
        # per device once launched: (indices, host buffer, event, blob)
        self._copies: list | None = None
        self._host: list | None = None

    def add(self, t):
        """Register ``t``; returns a zero-arg getter of its host copy."""
        if self._copies is not None:
            raise RuntimeError("FetchGroup already launched")
        _np_dtype(t.dtype)
        i = len(self._parts)
        self._parts.append(t)

        def get():
            self.materialize()
            return self._host[i]

        return get

    def launch(self) -> None:
        """Queue the window's copy (once); nothing here waits."""
        if self._copies is not None:
            return
        self._copies = []
        by_dev: dict = {}
        for i, t in enumerate(self._parts):
            by_dev.setdefault(t.device, []).append(i)
        for dev, idx in by_dev.items():
            flats = [self._parts[i].contiguous().view(-1).view(torch.uint8)
                     for i in idx]
            blob = flats[0] if len(flats) == 1 else torch.cat(flats)
            if dev.type != "cuda":
                self._copies.append((idx, blob, None, blob))
                continue
            with torch.cuda.device(dev):
                buf = _PINNED.take(blob.numel())
                buf[: blob.numel()].copy_(blob, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            self._copies.append((idx, buf, event, blob))

    def materialize(self) -> None:
        """Wait for the window's copy and split it into numpy arrays."""
        if self._host is not None:
            return
        self.launch()
        host = [None] * len(self._parts)
        for idx, buf, event, _blob in self._copies:
            if event is not None:
                with profiling.span("card_wait"):
                    event.synchronize()
            raw, off = buf.numpy(), 0
            for i in idx:
                t = self._parts[i]
                nb = t.numel() * t.element_size()
                host[i] = raw[off : off + nb].view(_np_dtype(t.dtype)).reshape(
                    tuple(t.shape)).copy()
                off += nb
            if event is not None:
                _PINNED.give(buf)
        self._host = host
        self._parts = [None] * len(host)  # the sources and blobs may go
        self._copies = []


def fetch_handle(t):
    """Register the reply tensor ``t`` for its copy to the host; returns
    a zero-arg getter of a WRITABLE numpy copy. Inside a drain's fetch
    window ``t`` joins the window's one copy (:class:`FetchGroup`);
    otherwise its own copy is queued at once."""
    stack = _ACTIVE_GROUPS.stack
    if stack:
        return stack[-1].add(t)
    group = FetchGroup()
    get = group.add(t)
    group.launch()
    return get


def drain_pipelined(parts, dispatch, *, sink=None, default_window=1):
    """The pipelined serving loop of the single-index, flat and sharded
    engines: ``dispatch(*args)`` for each tuple in ``parts`` returns a
    zero-arg finish; up to :func:`pipeline_depth` fetch windows stay
    dispatched but unfinished, windows finish in order, and ``sink``
    (deferred certified fallback reruns) is flushed BEFORE returning, so
    callers assemble replies only from patched parts. A window holds
    :func:`fetch_window` chunks (``default_window`` when the environment
    does not say) whose replies share one copy, queued when the window
    closes. Returns (id_parts, sim_parts). Timed as the spans
    ``dispatch`` (each dispatch half, each window's copy queued),
    ``finish`` (each window's split and finish halves, its waits on the
    card as ``card_wait`` inside it) and ``rerun`` (the sink's flush):
    utils/profiling.py."""
    depth = pipeline_depth()
    window = fetch_window(default_window)
    pending: deque = deque()  # (FetchGroup, [finish, ...]) per window
    id_parts, sim_parts = [], []

    def drain_window():
        group, fins = pending.popleft()
        with profiling.span("finish"):
            group.materialize()  # the window's one copy
            for fin in fins:
                i_p, s_p = fin()
                id_parts.append(i_p)
                sim_parts.append(s_p)

    def close(group, fins):
        with profiling.span("dispatch"):
            group.launch()
        pending.append((group, fins))
        while len(pending) > depth:
            drain_window()

    group, fins = FetchGroup(), []
    for args in parts:
        _ACTIVE_GROUPS.stack.append(group)
        try:
            with profiling.span("dispatch"):
                fins.append(dispatch(*args))
        finally:
            _ACTIVE_GROUPS.stack.pop()
        profiling.count("chunks", 1)
        if len(fins) >= window:
            close(group, fins)
            group, fins = FetchGroup(), []
    if fins:
        close(group, fins)
    while pending:
        drain_window()
    if sink is not None:
        with profiling.span("rerun"):
            sink.flush()  # patches id_parts/sim_parts rows in place
    return id_parts, sim_parts
