"""whole_batch_pct: of the queries the certified tier served in the
window's requests outside the profiled part, the share whose batch it
served again whole on the exact tier (more than a quarter of the batch
uncertified; audited batches apart), in percent: the port's record of
each ``search_batch`` (``whole_batch_queries`` over ``cert_queries``,
ops/scan.py CERT_STATS keys)."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None:
        return None
    q = int(log["cert_queries"].sum())
    if q <= 0:
        return None
    return 100.0 * int(log["whole_batch_queries"].sum()) / q
