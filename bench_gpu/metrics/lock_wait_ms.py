"""lock_wait_ms: ms a request waited for its index's lock (the port's
``lock_wait`` span, api.py ``HNSW.search_batch``), from the port's
record of each ``search_batch``, over the window's requests outside the
profiled part. None where the record has no ``lock_wait_ns`` field."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None or "lock_wait_ns" not in log:
        return None
    return 1e-6 * float(log["lock_wait_ns"].mean())
