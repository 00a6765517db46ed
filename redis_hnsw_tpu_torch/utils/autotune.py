"""Search-knob auto-tuning.

Port of ``redis_hnsw_tpu/utils/autotune.py``. The reference hardwires its
search beam to ef_construction (src/hnsw/core.rs:485), so its recall is
tied to a build-time parameter and unmeasurable without an outside
oracle. Here the index carries its own exact oracle (the exact scan), so
it can tune its batched-search knobs: probe an (ef_search, expand,
iters) ladder against the exact top k of a query sample, and return the
cheapest rung that meets the recall target.
"""

from __future__ import annotations

import time

import numpy as np


def _exact_topk(index, queries, k):
    """Ground truth from the index's own device snapshot: the exact scan
    (ops/scan.py scan_topk_exact_l2, kernel A on the card; kernel A′'s
    exact tier for hamming) over every live row, as [B, k] row ids."""
    from ..ops import scan as SC

    vecs, sqn, live = SC._scan_state(index)
    n_q = queries.shape[0]
    qd = SC.pad_queries(queries, SC.pad_pow2(n_q), vecs.device)
    k = min(int(k), int(vecs.shape[0]))
    if index.config.metric == "hamming":
        ids, _ = SC.scan_topk_exact_hamming(vecs, live, qd, k=k)
    else:
        ids, _ = SC.scan_topk_exact_l2(vecs, sqn, live, qd, k=k)
    return ids[:n_q].cpu().numpy()


DEFAULT_LADDER = (64, 96, 128, 192, 256, 320, 448, 640)


def tune(
    index,
    queries,
    k: int = 10,
    target_recall: float = 0.95,
    expand: int = 16,
    ef_ladder=DEFAULT_LADDER,
    iter_slack: int = 4,
    time_reps: int = 3,
) -> dict:
    """Return the fastest ``{ef_search, expand, iters}`` meeting
    ``target_recall`` on ``queries`` (exact oracle computed in-process).
    If nothing on the ladder reaches the target, returns the most
    accurate config found. Pass the result straight to search_batch:

        knobs = tune(idx, sample_queries, k=10, target_recall=0.95)
        idx.search_batch(batch, k=10, **knobs)
    """
    qs = np.atleast_2d(np.asarray(queries, dtype=index._vectors.dtype))
    truth = _exact_topk(index, qs, k)
    truth_sets = [set(row.tolist()) for row in truth]
    name_row = index._names.get

    def recall_of(res):
        hits = 0
        for b, rr in enumerate(res):
            rows = {name_row(r.name) for r in rr}
            hits += len(rows & truth_sets[b])
        return hits / (k * len(res))

    passing = []
    best = None
    for ef in ef_ladder:
        ex = min(expand, ef)
        iters = (ef + ex - 1) // ex + iter_slack
        res = index.search_batch(
            qs, k, ef_search=ef, expand=ex, iters=iters, engine="graph"
        )
        rec = recall_of(res)
        cfg = {"ef_search": ef, "expand": ex, "iters": iters}
        if best is None or rec > best[0]:
            best = (rec, cfg)
        if rec >= target_recall:
            passing.append((rec, cfg))
            break  # the ladder is monotone in work; first hit is cheapest

    if not passing:
        rec, cfg = best
        return {**cfg, "recall": rec, "qps": None}

    rec, cfg = passing[0]
    t0 = time.perf_counter()
    for _ in range(time_reps):
        index.search_batch(
            qs, k, ef_search=cfg["ef_search"], expand=cfg["expand"],
            iters=cfg["iters"], engine="graph",
        )
    dt = (time.perf_counter() - t0) / time_reps
    return {**cfg, "recall": rec, "qps": len(qs) / dt}
