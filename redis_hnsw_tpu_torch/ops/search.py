"""Batched search: the graph beam, engine routing, chunking, replies.

Port of ``redis_hnsw_tpu/ops/search.py``. Two engines serve
``search_batch``:

* the exact scan (ops/scan.py) -- ``engine="scan"``, and ``"auto"`` up to
  SCAN_MAX_ROWS padded rows;
* the **graph engine** -- ``engine="graph"``, and ``"auto"`` above
  SCAN_MAX_ROWS: a whole query batch walks the HNSW snapshot together.
  A vectorized greedy hill climb descends the upper layers
  (:func:`greedy_descent`), then a fixed-width layer-0 beam
  (:func:`beam_search`) expands the top ``expand`` unexpanded entries of
  every lane per step, scores their neighbours in one tile and merges
  by a sort, with no visited set (see :func:`beam_search`).

The JAX package runs both loops as ``lax.while_loop``s inside one jitted
program; here they are Python loops over torch ops, with one ``.item()``
sync per step for the loop condition, and the step count is the same.

Frontier scoring follows the snapshot's tier (ops/snapshot.py): the
f32/f16/bf16 neighbour blocks run kernel C (ops/cuda_gather.py) on the
card and its plain version ``block_neg_sq_l2`` on the CPU; the int8 block
tier, the int8 row table (``qrows``) and row gathers run plain torch. On
the card every row-path score (entry point, seeds, hill climb, row-gather
frontier) also goes through kernel C, in its row form, so a node's sim is
the same bits whichever path scored it. The JAX package's opt-in switch
between two implementations of one function,
``REDIS_HNSW_TPU_PALLAS_GATHER``, is not read: the block tier always runs
kernel C on the card.

Hamming indexes score ``-popcount(q XOR x)`` over packed int32 words with
torch ops on both devices (ops/distance.py ``block_hamming``,
``frontier_hamming``; the JAX package scores them in XLA, not Pallas):
integer sims, exact everywhere, whose final k are reported as they are.
Seeded search picks its pivots with kernel A′.

``engine="scan-approx"`` is the approx tier, served on kernel A's exact
select (ops/scan.py serve_block). REDIS_HNSW_TPU_REPLY=ids makes a
euclidean reply copy only its ids off the card and rescore the sims on
the host, on both engines, as the JAX package does (ops/scan.py
reply_ids_engaged).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..errors import DimensionMismatch
from ..utils import profiling
from . import distance as D
from .cuda_gather import fused_block_score, fused_row_score

NEG_INF = float("-inf")
_INF = float("inf")

# Lane cap per device call: per-step tiles scale with the batch, not with
# the index, so larger query sets are served in chunks of this many.
MAX_LANES = 2048


def max_lanes_for(n_pad: int) -> int:
    """Lane cap of one call over an ``n_pad``-row snapshot: per-step tiles
    scale with the lanes, not the rows, so it is MAX_LANES at every size."""
    return MAX_LANES


# Auto-engine crossover, as in the JAX package: at or below this many
# (padded) rows "auto" serves the exact scan, above it the graph beam.
SCAN_MAX_ROWS = {"euclidean": 1 << 21, "hamming": 1 << 21}

# Recall floor of the JAX package's scan-approx tier, which the
# recall_target routing rule reads (resolve_engine). It is a TPU
# measurement (0.9992 at 1M rows, 0.9996 at 1.9M, in the JAX package's
# artifacts/scan_tiers.json); the port serves the tier on kernel A's
# exact select, at recall 1.0.
APPROX_TIER_FLOOR = 0.999


def resolve_engine(engine: str, recall_target: float | None) -> str:
    """Apply the ``recall_target`` routing rule to an engine choice.

    ``recall_target`` is a guarantee, not a hint, so it only ever
    routes between engines with *known* recall: the exact scan (1.0 by
    construction) and the approx-select tier (APPROX_TIER_FLOOR). With
    ``engine="auto"`` a target above the tier floor pins the EXACT scan
    and a target at or below it picks the tier. An explicit engine
    choice is always honored; asking the graph engine for a
    recall_target is an error -- its recall depends on the data, so
    tune (ef_search, expand, iters) with utils/autotune.py's tune().
    """
    if engine not in ("auto", "graph", "scan", "scan-approx"):
        raise ValueError(f"unknown search engine {engine!r}")
    if recall_target is None:
        return engine
    rt = float(recall_target)
    if not 0.0 < rt <= 1.0:
        raise ValueError(
            f"recall_target must be in (0, 1], got {recall_target!r}"
        )
    if engine == "graph":
        raise ValueError(
            "recall_target routes the scan engines; graph-engine "
            "knobs are tuned with redis_hnsw_tpu_torch.tune()"
        )
    if engine == "auto":
        return "scan" if rt > APPROX_TIER_FLOOR else "scan-approx"
    return engine


# ---------------------------------------------------------------------------
# Scoring helpers.
# ---------------------------------------------------------------------------

def _score(metric, q, qn, vecs, vn, ids, mask):
    """Row-gathered scores of ``ids`` [B, J] (in range): kernel C's row
    form on the card, its plain version on the CPU; hamming rows through
    ``frontier_hamming`` on both."""
    if metric == "hamming":
        return D.frontier_hamming(q, vecs, ids, mask)
    if q.device.type == "cpu":
        return D.frontier_neg_sq_l2(q, qn, vecs, vn, ids, mask)
    sims = fused_row_score(q, qn, vecs, vn, ids.to(torch.int32))
    return torch.where(mask, sims, NEG_INF)


def _query_sqnorms(metric, q):
    if metric == "hamming":
        return torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    return D.sqnorms(q)


def _point_sims(metric, q, qn, vecs, vn, ids):
    mask = torch.ones((ids.shape[0], 1), dtype=torch.bool, device=q.device)
    return _score(metric, q, qn, vecs, vn, ids[:, None], mask)[:, 0]


def _entry_sims(q, qn, vecs, vn, ids, mask, dtype):
    """Scores of rows ``ids`` [B, J] with each row narrowed to the block
    element type ``dtype`` first: an entry point or seed then carries
    the same bits as its copies in the f16/bf16 neighbour blocks, so the
    beam's dedup sees one node, not two (the JAX package scores them
    from the f32 rows; on integer data the two agree exactly)."""
    B, J = ids.shape
    safe = ids.clamp(min=0).long()
    rows = vecs[safe].to(dtype).reshape(B * J, 1, vecs.shape[1])
    cand = torch.arange(B * J, dtype=torch.int32, device=q.device)
    sims = fused_block_score(
        q, qn, rows, vn[safe].reshape(B * J, 1), cand.reshape(B, J)
    )
    return torch.where(mask, sims, NEG_INF)


# ---------------------------------------------------------------------------
# Greedy descent over the upper layers (vectorized core.rs:869-874).
# ---------------------------------------------------------------------------

def hill_climb_layer(
    metric, q, qn, vecs, vn, adj_l, upper_of, ids, sims, active=None
):
    """ef=1 greedy step loop at one upper layer (core.rs:511-520).

    Per step every live lane gathers its current node's neighbour row,
    scores the [B, degU] tile and moves if the best neighbour improves
    (the first best on ties). ``active=None`` means all lanes; inactive
    lanes pass through unchanged."""
    live = torch.ones_like(ids, dtype=torch.bool) if active is None else active
    while bool(live.any()):
        u = upper_of[ids.long()]
        nbrs = adj_l[u.clamp(min=0).long()]              # [B, degU]
        valid = (nbrs >= 0) & (u >= 0)[:, None] & live[:, None]
        nb_safe = nbrs.clamp(min=0)
        nsims = _score(metric, q, qn, vecs, vn, nb_safe, valid)
        j = torch.argmax(nsims, dim=1, keepdim=True)
        bsim = nsims.gather(1, j)[:, 0]
        bid = nb_safe.gather(1, j)[:, 0]
        improved = bsim > sims
        ids = torch.where(improved, bid, ids)
        sims = torch.where(improved, bsim, sims)
        live = live & improved
    return ids, sims


def greedy_descent(metric, q, qn, vecs, vn, adj_up, upper_of, ep, max_layer):
    """Hill-climb from the entry point ``ep`` down layers ``max_layer``
    .. 1; returns every lane's layer-0 entry (ids [B] int32, sims [B])."""
    ids = torch.full((q.shape[0],), int(ep), dtype=torch.int32,
                     device=q.device)
    sims = _point_sims(metric, q, qn, vecs, vn, ids)
    for i in range(int(max_layer)):
        # layer l = max_layer - i is stored at adj_up[l - 1]
        ids, sims = hill_climb_layer(
            metric, q, qn, vecs, vn, adj_up[int(max_layer) - 1 - i],
            upper_of, ids, sims,
        )
    return ids, sims


# ---------------------------------------------------------------------------
# Fixed-width beam over one adjacency table (vectorized search_level).
# ---------------------------------------------------------------------------

# Extra beam slots carried in lazy-dedup mode (see beam_search).
LAZY_SLACK = 64


def _lazy_dedup() -> bool:
    """Opt-in lazy dedup (REDIS_HNSW_TPU_LAZY_DEDUP=1), as in the JAX
    package; parity mode (expand=1) always runs eager."""
    return os.environ.get("REDIS_HNSW_TPU_LAZY_DEDUP", "0") != "0"


def _sort_key_pid(key, pid):
    """Rows sorted ascending by (key, pid), stably -- the JAX package's
    ``lax.sort((key, pid), num_keys=2, is_stable=True)``. One stable sort
    of a packed int64: the key's order-preserving bits (``key + 0.0``
    first, since JAX's sort holds -0.0 equal to +0.0) above ``pid +
    2^31``. The original keys and pids are gathered in that order, so
    -0.0 keys keep their bits as they do in JAX."""
    bits = (key + 0.0).view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    packed = bits.to(torch.int64) * (1 << 32) + (pid.to(torch.int64) + (1 << 31))
    order = torch.argsort(packed, dim=1, stable=True)
    return key.gather(1, order), pid.gather(1, order)


def _inf_last(key, pid):
    """The JAX package's stable sort by ``key`` alone after the dedup
    marked duplicates +inf: the other keys are still in order, so it is
    a stable partition that moves every +inf key behind the rest."""
    order = torch.argsort((key == _INF).to(torch.int32), dim=1, stable=True)
    return key.gather(1, order), pid.gather(1, order)


def beam_search(
    metric, q, qn, vecs, vn, adj, ep_ids, ep_sims, ef: int,
    row_map=None, active=None, expand: int = 1, iters: int | None = None,
    nbrvec=None, nbrsqn=None, qrows=None, seed_ids=None, seed_sims=None,
):
    """Run the ef-wide beam for every lane; returns (ids, sims) [B, ef]
    sorted by descending sim, -1/-inf in empty slots.

    ``adj`` is any [R, F] adjacency table (layer 0 for queries;
    ``row_map`` maps global ids to its rows, -1 = absent). Lanes where
    ``active`` is False return their entry point untouched. Per step the
    top ``expand`` unexpanded entries of every lane are expanded at once
    (expand=1 is the reference's pop-best order, core.rs:630-668), their
    [B, expand*F] neighbours scored in one tile, and beam, frontier and
    expanded-marked copies of the picked entries merged by one stable
    sort on (-sim, pid). ``iters`` caps the steps (default
    4*ceil(ef/expand) + 16); the loop also ends when no lane has an
    unexpanded entry left.

    State: sims [B, wb] f32 and a PACKED int32 ``pid = id << 1 |
    unexpanded`` (-1 in empty slots; -1 >> 1 == -1). Within a (sim, id)
    tie class an expanded copy (bit 0) sorts first and survives the
    adjacent-equal dedup on ``pid >> 1``, so marking an entry expanded is
    injecting its flagged copy into the merge. No visited set: the
    beam's worst sim never decreases, so a rejected node cannot
    re-enter, and re-proposals of members die in the dedup -- which needs
    every re-proposal of a node to carry bit-identical sims (the
    scorers are position independent, ops/distance.py, kernel C).
    Lazy dedup (REDIS_HNSW_TPU_LAZY_DEDUP=1, expand > 1) carries
    LAZY_SLACK extra slots and leaves dead ones in place for the next
    merge, skipping the second sort; one cleanup sort runs at the end.
    """
    B = q.shape[0]
    F = adj.shape[1]
    E = max(1, min(expand, ef))
    if iters is None:
        iters = 4 * ((ef + E - 1) // E) + 16
    lazy = E > 1 and _lazy_dedup()
    wb = ef + (min(LAZY_SLACK, E * F) if lazy else 0)
    dev = q.device
    quant_blocks = nbrvec is not None and nbrvec.dtype == torch.int8
    if qrows is not None or quant_blocks:
        q8, qs8 = D.quantize_query(q)  # once per call, reused every step

    # inactive lanes: entry point pre-expanded -> inert for the loop
    unexp0 = (
        torch.ones_like(ep_ids) if active is None
        else active.to(torch.int32)
    )
    head_pid = ((ep_ids << 1) | unexp0)[:, None]
    head_sims = ep_sims[:, None]
    if seed_ids is not None:
        # extra unexpanded entry points (an extension; the reference
        # starts every beam from the descent's entry point, core.rs:876).
        # Seeds equal to the entry point are dropped.
        ok = (seed_ids >= 0) & (seed_ids != ep_ids[:, None])
        head_pid = torch.cat(
            [head_pid, torch.where(ok, (seed_ids << 1) | 1, -1)], dim=1
        )
        head_sims = torch.cat(
            [head_sims, torch.where(ok, seed_sims, NEG_INF)], dim=1
        )
    pad = wb - head_pid.shape[1]
    beam_pid = torch.cat(
        [head_pid.to(torch.int32),
         torch.full((B, pad), -1, dtype=torch.int32, device=dev)], dim=1
    )
    beam_sims = torch.cat(
        [head_sims, torch.full((B, pad), NEG_INF, device=dev)], dim=1
    )
    no_dup = torch.zeros((B, 1), dtype=torch.bool, device=dev)

    step = 0
    while step < iters and bool(
        (((beam_pid & 1) == 1) & (beam_sims != NEG_INF)).any()
    ):
        # top-E unexpanded entries per lane (c.pop() of core.rs:631):
        # key = -sim, +inf when expanded or empty
        pick_key = torch.where((beam_pid & 1) == 1, -beam_sims, _INF)
        k_sorted, pid_sorted = _sort_key_pid(pick_key, beam_pid)
        k_top = k_sorted[:, :E]
        picked = k_top != _INF
        cids = torch.where(picked, pid_sorted[:, :E] >> 1, -1)

        crow = cids if row_map is None else row_map[cids.clamp(min=0).long()]
        crow = torch.where(cids >= 0, crow, -1)
        nbrs = adj[crow.clamp(min=0).long()]               # [B, E, F]
        nbrs = torch.where((crow >= 0)[:, :, None], nbrs, -1).reshape(B, E * F)
        fresh = nbrs >= 0
        if nbrvec is not None:
            csafe = crow.clamp(min=0)
            if metric == "hamming":
                nsims = D.block_hamming(q, nbrvec, csafe, fresh)
            elif quant_blocks:
                nsims = D.block_int8_neg_sq_l2(
                    q8, qs8, qn, nbrvec, nbrsqn, csafe, fresh
                )
            else:
                nsims = torch.where(
                    fresh,
                    fused_block_score(q, qn, nbrvec, nbrsqn,
                                      csafe.to(torch.int32)),
                    NEG_INF,
                )
        elif qrows is not None:
            nsims = D.frontier_int8_neg_sq_l2(
                q8, qs8, qn, qrows, nbrs.clamp(min=0), fresh
            )
        else:
            nsims = _score(metric, q, qn, vecs, vn, nbrs.clamp(min=0), fresh)

        # merge beam U frontier U expanded-marked copies of the picked
        # entries, dedup adjacent equal ids, keep the best wb
        frontier_pid = (nbrs << 1) | 1                     # -1 stays -1
        copy_pid = torch.where(picked, cids << 1, -2)      # -2 >> 1 == -1
        copy_key = torch.where(picked, k_top, _INF)
        k1, p1 = _sort_key_pid(
            torch.cat([-beam_sims, -nsims, copy_key], dim=1),
            torch.cat([beam_pid, frontier_pid, copy_pid], dim=1),
        )
        ids1 = p1 >> 1
        dup = torch.cat(
            [no_dup, (ids1[:, 1:] == ids1[:, :-1]) & (ids1[:, 1:] >= 0)],
            dim=1,
        )
        k1 = torch.where(dup, _INF, k1)
        p1 = torch.where(dup, -1, p1)
        if not lazy:
            k1, p1 = _inf_last(k1, p1)
        beam_pid = p1[:, :wb]
        beam_sims = -k1[:, :wb]
        step += 1

    if lazy:
        # one cleanup sort compacts the dead slots out before slicing
        kf, beam_pid = _sort_key_pid(-beam_sims, beam_pid)
        return beam_pid[:, :ef] >> 1, -kf[:, :ef]
    return beam_pid >> 1, beam_sims


# ---------------------------------------------------------------------------
# Full pipeline: descent, seeds, beam, exact rescore of the final k.
# ---------------------------------------------------------------------------

def search_pipeline(
    vecs, sqn, adj0, adj_up, upper_of, ep, max_layer, queries,
    *, ef: int, k: int, metric: str, expand: int = 1,
    iters: int | None = None, nbrvec=None, nbrsqn=None,
    qrows=None, seed_ids=None,
):
    """Descent + beam + direct-form rescore of the final
    ``min(k, ef)``, re-sorted by ``(-sim, id)``; returns (ids, sims)
    device tensors [B, min(k, ef)]. Hamming sims are exact integers
    already: the final k keep the beam's sims and order."""
    qn = _query_sqnorms(metric, queries)
    ep_ids, ep_sims = greedy_descent(
        metric, queries, qn, vecs, sqn, adj_up, upper_of, ep, max_layer
    )
    seed_sims = None
    if seed_ids is not None:
        # seeds score through the same arithmetic as every other beam
        # entry, so re-proposals during traversal carry identical sims
        seed_sims = _score(
            metric, queries, qn, vecs, sqn, seed_ids.clamp(min=0),
            seed_ids >= 0,
        )
    if nbrvec is not None and nbrvec.dtype in (torch.float16, torch.bfloat16):
        ep_sims = _entry_sims(
            queries, qn, vecs, sqn, ep_ids[:, None],
            torch.ones_like(ep_ids, dtype=torch.bool)[:, None], nbrvec.dtype,
        )[:, 0]
        if seed_ids is not None:
            seed_sims = _entry_sims(
                queries, qn, vecs, sqn, seed_ids, seed_ids >= 0,
                nbrvec.dtype,
            )
    beam_ids, beam_sims = beam_search(
        metric, queries, qn, vecs, sqn, adj0, ep_ids, ep_sims, ef,
        expand=expand, iters=iters, nbrvec=nbrvec, nbrsqn=nbrsqn,
        qrows=qrows, seed_ids=seed_ids, seed_sims=seed_sims,
    )
    k_eff = min(k, ef)
    k_ids = beam_ids[:, :k_eff]
    valid = beam_sims[:, :k_eff] != NEG_INF
    if metric == "hamming":
        return k_ids, torch.where(valid, beam_sims[:, :k_eff], NEG_INF)
    k_sims = D.exact_neg_sq_l2(queries, vecs, k_ids.clamp(min=0).long(), valid)
    # exact rescoring can reorder near-ties vs the matmul-form beam; the
    # reply contract is descending by (sim, -id)
    return D.resort_desc(k_ids, k_sims)


# Pivot pool size for seeded search: rows strided over the live id
# space, refreshed per mutation epoch.
PIVOT_POOL = 1024


def _pivot_pool(index, snap):
    """Per-epoch cache of (global ids [P] int32, rows [P, D], sqnorms
    [P]) on the snapshot's device: a strided sample of live rows (packed
    words, and zero sqnorms, for hamming). Seeded search scans it (kernel
    A, or A′) to give each lane its ``seeds`` closest pivots as extra beam
    entry points."""
    cached = getattr(index, "_pivot_cache", None)
    if cached is not None and cached[0] == index.epoch:
        return cached[1]
    h = min(len(index._levels), snap.n_pad)
    live_rows = np.flatnonzero(index._levels[:h] >= 0)
    p = min(PIVOT_POOL, len(live_rows))
    pick = np.unique(
        live_rows[np.linspace(0, len(live_rows) - 1, p).astype(np.int64)]
    ).astype(np.int32)
    ids_dev = torch.from_numpy(pick).to(snap.vecs.device)
    sel = ids_dev.long()
    pool = (ids_dev, snap.vecs[sel], snap.sqnorms[sel])
    index._pivot_cache = (index.epoch, pool)
    return pool


def _seed_ids_for(pool, qd, seeds: int, width: int | None = None):
    """Top-``seeds`` pivots per lane as global row ids [B, seeds]; at most
    ``width`` columns (default the pool's rows). The sharded index scans
    every shard's pool at ``min(seeds, PIVOT_POOL)``, as the JAX package
    scans its -1-padded pools: slots past a short pool's rows are -1."""
    from .scan import scan_topk

    ids_dev, table, sqn = pool
    s = min(int(seeds), int(table.shape[0]) if width is None else width)
    live = torch.ones(table.shape[0], dtype=torch.bool, device=table.device)
    metric = "hamming" if table.dtype == torch.int32 else "euclidean"
    local, _ = scan_topk(table, sqn, live, qd, k=s, metric=metric)
    return torch.where(local >= 0, ids_dev[local.clamp(min=0).long()], -1)


def _dispatch_search(
    snap, qs, ef: int, k: int, expand: int, iters=None,
    seeds: int = 0, pool=None, ids_only: bool = False,
):
    """One beam call over the query block ``qs`` (numpy, or a tensor on
    the device), padded to a power of two >= 8 lanes, with its reply
    registered with ops/scan.py ``fetch_handle``; returns ``finish()``,
    which gives the trimmed (ids, sims) numpy reply, or ``(ids, None)``
    with ``ids_only`` (the ids-reply mode copies only the ids off the
    card). The beam reads its loop condition on the host at every step
    (:func:`beam_search`), so this half waits for the card; only the
    reply's copy is left to the finish."""
    from .scan import fetch_handle, pad_pow2, pad_queries

    n_q = qs.shape[0]
    qd = pad_queries(qs, pad_pow2(n_q), snap.vecs.device)
    seed_ids = None
    if seeds > 0 and ef > 1 and pool is not None:
        seed_ids = _seed_ids_for(pool, qd, min(seeds, ef - 1))
    ids, sims = search_pipeline(
        snap.vecs, snap.sqnorms, snap.adj0, snap.adj_up, snap.upper_of,
        snap.ep, snap.max_layer, qd, ef=ef, k=int(k), metric=snap.metric,
        expand=expand, iters=iters, nbrvec=snap.nbrvec, nbrsqn=snap.nbrsqn,
        qrows=snap.qrows, seed_ids=seed_ids,
    )
    get_ids = fetch_handle(ids[:n_q])
    get_sims = None if ids_only else fetch_handle(sims[:n_q])
    return lambda: (get_ids(), None if get_sims is None else get_sims())


def coerce_queries(queries, dtype, width: int, metric: str):
    """Queries as a 2-D numpy array of the table's dtype, or a 2-D
    float32 torch tensor as given (already on a device); raises
    DimensionMismatch on a wrong width."""
    if (
        isinstance(queries, torch.Tensor)
        and queries.dim() == 2
        and queries.dtype == torch.float32
        and dtype == np.float32
    ):
        qs = queries
    else:
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        qs = np.atleast_2d(np.asarray(queries, dtype=dtype))
    if qs.shape[1] != width:
        raise DimensionMismatch(
            qs.shape[1] * (32 if metric == "hamming" else 1)
        )
    return qs


def empty_reply(n_q: int, k: int, reply: str):
    """The reply of an empty index: no results per query (columnar:
    None / -inf in every slot)."""
    if reply == "columnar":
        return (
            np.full((n_q, int(k)), None, object),
            np.full((n_q, int(k)), NEG_INF, np.float32),
        )
    return [[] for _ in range(n_q)]


def assemble(names_array, ids, sims, reply: str):
    """Per-query SearchResult lists (nearest first) or the columnar
    (names, sims) pair from [B, k] numpy ids/sims. Like the reference's
    search reply (src/lib.rs:484-495, types.rs:445-457) batch results
    carry (similarity, name) only; empty slots (id -1 or sim -inf) are
    dropped, or None / -inf in the columnar form. Timed as the span
    ``assemble``."""
    with profiling.span("assemble"):
        if reply != "columnar":
            return reply_objects(names_array, ids, sims)
        names = names_array[np.maximum(ids, 0)]
        invalid = (ids < 0) | np.isneginf(sims)
        if invalid.any():
            names = names.copy()
            names[invalid] = None
            sims = np.where(invalid, NEG_INF, sims).astype(np.float32)
        return names, np.asarray(sims, np.float32)


def reply_objects(names_array, ids, sims):
    """Per-query SearchResult lists, nearest first, from the object
    ndarray ``names_array`` (row -> name) and [B, k] numpy ids / sims;
    slots with id < 0 or sim -inf are dropped. One native call
    (csrc/reply.cpp ``build_reply``, counted ``native_reply_queries``)
    where the extension loads: its results are untracked by the cycle
    collector, and the call holds the collector off while it runs, so no
    collection starts inside it. Else
    :func:`reply_loop`, the same lists."""
    from .. import native_reply

    ext = native_reply.load()
    if ext is None:
        return reply_loop(names_array, ids, sims)
    out = ext.build_reply(names_array, ids, sims)
    profiling.count("native_reply_queries", len(out))
    return out


def reply_loop(names_array, ids, sims):
    """:func:`reply_objects` in Python, with models/result.py's
    dataclass: the form where the extension cannot be built."""
    from ..models.result import SearchResult

    names_l = names_array[np.maximum(ids, 0)].tolist()
    sims_l = sims.tolist()
    if (ids >= 0).all() and not np.isneginf(sims).any():
        return [
            [SearchResult(s, n) for n, s in zip(brow_names, bsim)]
            for brow_names, bsim in zip(names_l, sims_l)
        ]
    neg_inf = float("-inf")
    return [
        [
            SearchResult(s, n)
            for row, s, n in zip(brow, bsim, bnames)
            if row >= 0 and s != neg_inf
        ]
        for brow, bsim, bnames in zip(ids.tolist(), sims_l, names_l)
    ]


def search_batch(
    index, queries, k: int, ef_search: int | None = None,
    expand: int = 1, iters: int | None = None, engine: str = "auto",
    reply: str = "objects", seeds: int = 0,
    recall_target: float | None = None, host_qs=None,
    staleness: int = 0,
):
    """Host entry: batched k-NN over an index. Returns per-query result
    lists of models.hnsw.SearchResult, nearest first -- or, with
    ``reply="columnar"``, the pair ``(names, sims)`` of [B, k] arrays
    (object / float32; empty slots None / -inf).

    ``engine``: ``"scan"`` -- the exact scan (ops/scan.py); ``"graph"``
    -- the batched HNSW beam (approximate; ``ef_search`` (default
    ef_construction), ``expand``, ``iters`` and ``seeds`` tune it, the
    scan ignores them); ``"scan-approx"`` -- the approx tier (kernel
    A's exact select here, ops/scan.py serve_block); ``"auto"``
    (default) -- the scan up to SCAN_MAX_ROWS padded rows, the graph
    beam above it. ``recall_target`` turns the route into a guarantee
    (resolve_engine). ``host_qs`` mirrors device-resident ``queries``
    on the host for REDIS_HNSW_TPU_REPLY=ids (numpy queries are their
    own mirror). ``staleness`` > 0 serves from the bounded-stale
    snapshot view (at most that many mutation epochs behind;
    models/hnsw.py device_snapshot).
    """
    from .scan import _scan_state, ids_reply_engaged

    cfg = index.config
    engine = resolve_engine(engine, recall_target)
    with profiling.span("prepare"):
        qs = coerce_queries(
            queries, index._vectors.dtype, index._vectors.shape[1],
            cfg.metric,
        )
        n_q = qs.shape[0]
        profiling.count("queries", n_q)
        if reply not in ("objects", "columnar"):
            raise ValueError(f"unknown reply mode {reply!r}")
        if index.enterpoint < 0 or index.node_count == 0:
            return empty_reply(n_q, k, reply)
        snap = index.device_snapshot(max_staleness=staleness)
        use_scan = engine in ("scan", "scan-approx") or (
            engine == "auto"
            and snap.n_pad <= SCAN_MAX_ROWS.get(cfg.metric, 0)
        )
        if use_scan:
            state = _scan_state(index, max_staleness=staleness)
    hq = host_qs if isinstance(qs, torch.Tensor) else qs
    ids_reply = ids_reply_engaged(cfg.metric, hq, cfg.dim, snap.vecs.device)
    if use_scan:
        ids, sims = scan_block(
            state, qs, k, metric=cfg.metric,
            approx=engine == "scan-approx", ids_reply=ids_reply,
            host_qs=hq, host_vecs=index._vectors,
        )
    else:
        ids, sims = _graph_batch(index, snap, qs, k, ef_search, expand,
                                 iters, seeds, hq, ids_reply)
    return assemble(index._names.names_array(), ids, sims, reply)


def scan_block(state, qs, k: int, *, metric: str, approx: bool = False,
               ids_reply: bool = False, host_qs=None, host_vecs=None):
    """The single-card chunk loop of the HNSW scan route and the flat
    index: the query block ``qs`` (numpy, or on the card) over a scan
    state (ops/scan.py ``_scan_state``, models/flat.py ``scan_state``),
    in chunks of ``max_lanes_for`` queries (one copy to the card where
    there are more), each served by ops/scan.py ``serve_chunk`` through
    the pipelined drain, a block of one chunk too. The certified tier's
    fallback reruns coalesce in one ``CertRerunSink``, and the fetch
    window defaults to FETCH_WINDOW_FAST where the certified
    (``certified_serves``) or approx tier serves, as in the JAX package,
    else to 1. ``host_qs`` (None where the queries are on the card only)
    and ``host_vecs``: see ``serve_chunk``. Returns the (ids, sims) numpy
    reply [n_q, min(k, rows)]."""
    from . import scan as SC

    table, vecs, _, _, _ = state
    n_rows, width = int(table.shape[0]), int(table.shape[1])
    k = min(int(k), n_rows)
    n_q = qs.shape[0]
    if n_q == 0:
        return np.empty((0, k), np.int32), np.empty((0, k), np.float32)
    if vecs is None and host_qs is None:
        # the resident tier's rescore queries, copied off the card once
        host_qs = qs.cpu().numpy()
    chunk = max_lanes_for(n_rows)
    sink = SC.CertRerunSink()
    qd = qs
    if n_q > chunk:
        # one host->device copy for the whole block; the chunks below
        # are then device-side slices
        qd = SC.pad_queries(qs, n_q, table.device)
    serve = functools.partial(
        SC.serve_chunk, state, k=k, metric=metric, approx=approx,
        rerun_sink=sink, ids_reply=ids_reply, host_vecs=host_vecs,
    )
    certified = SC.certified_serves(metric, n_rows, width, approx=approx,
                                    tiered=table is not vecs)
    id_parts, sim_parts = SC.drain_pipelined(
        ((qd[lo : lo + chunk],
          None if host_qs is None else host_qs[lo : lo + chunk])
         for lo in range(0, n_q, chunk)),
        serve, sink=sink,
        default_window=SC.FETCH_WINDOW_FAST if approx or certified else 1,
    )
    return np.concatenate(id_parts), np.concatenate(sim_parts)


def _one_chunk(dispatch):
    """A block of one chunk, served without the pipelined drain:
    ``dispatch()`` then its finish, timed as their spans."""
    profiling.count("chunks", 1)
    with profiling.span("dispatch"):
        fin = dispatch()
    with profiling.span("finish"):
        return fin()


def _graph_batch(index, snap, qs, k, ef_search, expand, iters, seeds,
                 hq=None, ids_only=False):
    """The graph engine's (ids, sims) numpy reply for the whole block,
    served MAX_LANES lanes per call, through the pipelined drain for
    parity with the scan route (its beam waits for the card at every
    step, so the drain only defers each reply's copy). With ``ids_only``
    (ops/scan.py ``ids_reply_engaged``) a reply copies only its ids off
    the card and its sims are rescored on the host against ``hq``."""
    from .scan import drain_pipelined, host_exact_sims, pad_queries, sort_reply

    ef = index.config.ef_construction if ef_search is None else int(ef_search)
    ef = max(ef, 1)
    pool = _pivot_pool(index, snap) if seeds > 0 else None
    n_q = qs.shape[0]
    chunk = max_lanes_for(snap.n_pad)
    if n_q <= chunk:
        ids, sims = _one_chunk(lambda: _dispatch_search(
            snap, qs, ef, k, expand, iters, seeds=seeds, pool=pool,
            ids_only=ids_only))
    else:
        # one host->device copy for the whole block; the chunks below
        # are then device-side slices
        qd = pad_queries(qs, n_q, index.device)
        id_parts, sim_parts = drain_pipelined(
            ((qd[lo : lo + chunk],) for lo in range(0, n_q, chunk)),
            lambda part: _dispatch_search(
                snap, part, ef, k, expand, iters, seeds=seeds, pool=pool,
                ids_only=ids_only),
        )
        ids = np.concatenate(id_parts)
        sims = None if ids_only else np.concatenate(sim_parts)
    if ids_only:
        # the host rescore's sums can differ from the card's by an ulp;
        # the reply is re-sorted so it stays monotonic
        return sort_reply(ids, host_exact_sims(index._vectors, hq, ids))
    return ids, sims
