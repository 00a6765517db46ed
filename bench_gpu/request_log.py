"""The port's own per-request records of a run's window, for the readers
of the program's spans and counters (``metrics/<name>.py``).

``HNSW.search_batch`` writes one record a call into a ring the port
keeps (``redis_hnsw_tpu_torch/utils/profiling.py``, ``recent(n)``). The
traffic driver calls it once a request and nothing calls it after the
window, so the window's records are the newest ``len(run.latencies_s)``.
"""

from __future__ import annotations


def window(run):
    """{field: array} of the window's records served without the
    profiler (its annotations slow the host), or None where the port
    keeps no such records, the ring does not hold the whole window, or
    the records' completed queries do not sum to the queries the window
    answered."""
    try:
        from redis_hnsw_tpu_torch.utils.profiling import recent
    except ImportError:
        return None
    n = len(run.latencies_s)
    if n <= 0:
        return None
    log = recent(n)
    if len(log["queries"]) < n:
        return None
    done = log["queries"] * (1 - log["failed"])
    if int(done.sum()) != run.answered_queries:
        return None
    keep = log["profiled"] == 0
    if not keep.any():
        return None
    return {name: col[keep] for name, col in log.items()}


def mean_ms(run, *fields):
    """The mean over the window's unprofiled requests of the sum of the
    ns ``fields``, in ms; None as :func:`window`."""
    log = window(run)
    if log is None:
        return None
    return 1e-6 * float(sum(log[f] for f in fields).mean())
