"""cert_skip_pct: of the queries the window's requests outside the
profiled part asked, the share that a failing certificate left to the
exact tier without a certified pass, in percent: the port's record of
each ``search_batch``, ``cert_skipped_queries`` over ``queries``
(ops/scan.py ``CertHistory``). None where the record has no
``cert_skipped_queries`` field."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None or "cert_skipped_queries" not in log:
        return None
    q = int(log["queries"].sum())
    if q <= 0:
        return None
    return 100.0 * int(log["cert_skipped_queries"].sum()) / q
