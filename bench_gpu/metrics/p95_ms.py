"""p95_ms: the 95th percentile (nearest rank) of every request's latency
in the window, send to whole reply, host clock. A failed request counts
as beyond any limit."""

import math

FAILED_MS = 1e9  # a failed request's latency, beyond any limit


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    v = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return FAILED_MS if math.isinf(v) else v * 1e3
