"""The comparison that decides ``correct``.

Each checked answer is one query's reply as the client got it: ``ids``
(the row numbers its names give, -1 where it gave none it could parse),
``sims`` and ``bad`` (the reply was malformed where it was read). Three
numbers are compared, each with its limit from the configuration file:

* ``bad_answers``: answers that are missing, hold other than k results,
  name a row twice or a row that is not there, or are not nearest first
  (similarities not descending). Limit 0.
* ``sim_err``: the widest gap between a reported similarity and the
  float64 similarity of the row it names (for ``euclidean``,
  ``-||q - x||^2``), relative to that similarity.
* ``rank_gap``: the widest share by which a named row's float64 distance
  exceeds the float64 distance of the query's true k-th nearest row:
  0 when every answer is the exact top k.

Pure numpy on the host; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

NAMES = ("bad_answers", "sim_err", "rank_gap")


def malformed(ids: np.ndarray, sims: np.ndarray, bad: np.ndarray,
              n_rows: int) -> np.ndarray:
    """[Q] bool: answers that break the reply's form."""
    out = bad.copy()
    out |= ((ids < 0) | (ids >= n_rows)).any(axis=1)
    srt = np.sort(ids, axis=1)
    out |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    out |= ~np.isfinite(sims).all(axis=1)
    with np.errstate(invalid="ignore"):
        out |= (np.diff(sims, axis=1) > 0).any(axis=1)
    return out


def readings(ids, sims, bad, d_named, s_named, d_kth, n_rows: int) -> dict:
    """The three numbers over the checked answers. ``d_named`` [Q, k] is
    the float64 distance of each named row and ``s_named`` its float64
    similarity (any value where the answer is malformed), ``d_kth`` [Q]
    the float64 distance of each query's true k-th nearest row."""
    broken = malformed(ids, sims, bad, n_rows)
    good = ~broken
    sim_err = rank_gap = 0.0
    if good.any():
        d, want = d_named[good], s_named[good]
        scale = np.maximum(np.abs(want), np.finfo(np.float64).tiny)
        sim_err = float(np.max(np.abs(sims[good] - want) / scale))
        kth = np.maximum(d_kth[good], np.finfo(np.float64).tiny)
        rank_gap = float(max(0.0, np.max((d - kth[:, None]) / kth[:, None])))
    return {"bad_answers": int(broken.sum()), "sim_err": sim_err,
            "rank_gap": rank_gap}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct iff none exceeds its limit."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in NAMES}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
