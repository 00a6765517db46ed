"""exact_tier_pct: of the queries the window's requests outside the
profiled part asked, the share the exact tier served first-hand (kernel
A or A′ alone), in percent: the port's record of each ``search_batch``,
``exact_queries`` over ``queries``. None where the record has no
``exact_queries`` field."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None or "exact_queries" not in log:
        return None
    q = int(log["queries"].sum())
    if q <= 0:
        return None
    return 100.0 * int(log["exact_queries"].sum()) / q
