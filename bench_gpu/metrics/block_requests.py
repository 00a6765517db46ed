"""block_requests: the requests answered by the one search that answered
a request, the request included (api.py's combining front on the
index's lock: 1 where it was served alone), from the port's record of
each ``search_batch``, the mean over the window's requests outside the
profiled part. None where the record has no ``block_requests`` field."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None or "block_requests" not in log:
        return None
    return float(log["block_requests"].mean())
