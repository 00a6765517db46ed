"""reply_ms: host milliseconds a request spent in ops/search.py
``assemble`` (the reply's objects), over the window's requests outside
the profiled part (whose host work the profiler slows)."""


def read(run):
    n = run.counters.get("requests_unprofiled", 0)
    if run.trace is None or n <= 0:
        return None
    spans = run.trace.spans_s.get("assemble", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / n
