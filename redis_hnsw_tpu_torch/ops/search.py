"""Batched search entry: engine routing, query chunking, reply assembly.

Port of ``redis_hnsw_tpu/ops/search.py`` :: ``resolve_engine`` and
``search_batch``. The graph-beam traversal of that module (and the auto
route to it above SCAN_MAX_ROWS) comes with the graph engine, ROADMAP
queue 1 item 6; until then those routes raise. The scan (ops/scan.py)
serves everything below SCAN_MAX_ROWS, exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DimensionMismatch

NEG_INF = float("-inf")

# Lane cap per device call: larger query sets are served in chunks.
MAX_LANES = 2048

# Auto-engine crossover, as in the JAX package: at or below this many
# (padded) rows "auto" serves the exact scan, above it the graph beam.
SCAN_MAX_ROWS = {"euclidean": 1 << 21, "hamming": 1 << 21}

# Recall floor of the JAX package's scan-approx tier, which the
# recall_target routing rule reads (resolve_engine).
APPROX_TIER_FLOOR = 0.999


def resolve_engine(engine: str, recall_target: float | None) -> str:
    """Apply the ``recall_target`` routing rule to an engine choice.

    ``recall_target`` is a guarantee, not a hint, so it only ever
    routes between engines with *known* recall: the exact scan (1.0 by
    construction) and the approx-select tier (APPROX_TIER_FLOOR). With
    ``engine="auto"`` a target above the tier floor pins the EXACT scan
    and a target at or below it picks the tier. An explicit engine
    choice is always honored; asking the graph engine for a
    recall_target is an error.
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
            "recall_target routes the scan engines; the graph engine "
            "is tuned with ef_search, expand and iters"
        )
    if engine == "auto":
        return "scan" if rt > APPROX_TIER_FLOOR else "scan-approx"
    return engine


def not_ported_approx():
    return NotImplementedError(
        "the scan-approx tier is not ported yet (ROADMAP queue 1 item 10)"
    )


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
    dropped, or None / -inf in the columnar form."""
    from ..models.hnsw import SearchResult

    names = names_array[np.maximum(ids, 0)]
    if reply == "columnar":
        invalid = (ids < 0) | np.isneginf(sims)
        if invalid.any():
            names = names.copy()
            names[invalid] = None
            sims = np.where(invalid, NEG_INF, sims).astype(np.float32)
        return names, np.asarray(sims, np.float32)
    ids_l = ids.tolist()
    sims_l = sims.tolist()
    names_l = names.tolist()
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
        for brow, bsim, bnames in zip(ids_l, sims_l, names_l)
    ]


def search_batch(
    index, queries, k: int, ef_search: int | None = None,
    expand: int = 1, iters: int | None = None, engine: str = "auto",
    reply: str = "objects", seeds: int = 0,
    recall_target: float | None = None, staleness: int = 0,
):
    """Host entry: batched k-NN over an index. Returns per-query result
    lists of models.hnsw.SearchResult, nearest first -- or, with
    ``reply="columnar"``, the pair ``(names, sims)`` of [B, k] arrays
    (object / float32; empty slots None / -inf).

    ``engine``: ``"scan"`` -- the exact scan (ops/scan.py); ``"auto"``
    (default) -- the scan up to SCAN_MAX_ROWS padded rows; above it, and
    for ``"graph"``, the graph beam, which is not ported yet and raises,
    as does ``"scan-approx"``. ``ef_search``, ``expand``, ``iters`` and
    ``seeds`` tune the graph beam; the scan ignores them.
    ``recall_target`` turns the route into a guarantee (resolve_engine).
    ``staleness`` > 0 serves from the bounded-stale snapshot view (at
    most that many mutation epochs behind; models/hnsw.py
    device_snapshot).
    """
    from .scan import CertRerunSink, pad_queries, scan_dispatch

    cfg = index.config
    engine = resolve_engine(engine, recall_target)
    if engine == "scan-approx":
        raise not_ported_approx()
    qs = coerce_queries(
        queries, index._vectors.dtype, index._vectors.shape[1], cfg.metric
    )
    n_q = qs.shape[0]
    if reply not in ("objects", "columnar"):
        raise ValueError(f"unknown reply mode {reply!r}")
    if index.enterpoint < 0 or index.node_count == 0:
        return empty_reply(n_q, k, reply)
    if cfg.metric == "hamming":
        raise NotImplementedError(
            "hamming search_batch is not ported yet (ROADMAP queue 1 "
            "item 9)"
        )
    snap = index.device_snapshot(max_staleness=staleness)
    use_scan = engine == "scan" or (
        engine == "auto" and snap.n_pad <= SCAN_MAX_ROWS.get(cfg.metric, 0)
    )
    if not use_scan:
        raise NotImplementedError(
            f"the graph engine (engine={engine!r}, {snap.n_pad} padded "
            "rows) is not ported yet (ROADMAP queue 1 item 6)"
        )
    if n_q > MAX_LANES:
        sink = CertRerunSink()
        # one host->device copy for the whole block; the chunks below
        # are then device-side slices
        qd = pad_queries(qs, n_q, index.device)
        parts = [
            scan_dispatch(
                index, qd[lo : lo + MAX_LANES], k, cert_sink=sink,
                staleness=staleness,
            )
            for lo in range(0, n_q, MAX_LANES)
        ]
        sink.flush()  # patches the parts' rows in place
        ids = np.concatenate([p[0] for p in parts])
        sims = np.concatenate([p[1] for p in parts])
    else:
        ids, sims = scan_dispatch(index, qs, k, staleness=staleness)
    return assemble(index._names.names_array(), ids, sims, reply)
