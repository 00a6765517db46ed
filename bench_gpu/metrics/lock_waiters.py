"""lock_waiters: the other requests that held or waited for the index's
lock as a request began to wait for it (api.py ``IndexLock``), from the
port's record of each ``search_batch``, the mean over the window's
requests outside the profiled part. None where the record has no
``lock_waiters`` field."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None or "lock_waiters" not in log:
        return None
    return float(log["lock_waiters"].mean())
