"""reply_objects_ms: ms a request in the port's ``assemble`` span
(ops/search.py, the reply's objects) less the collector's pauses inside
it, from the port's record of each ``search_batch``, over the window's
requests outside the profiled part."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None:
        return None
    return 1e-6 * float((log["assemble_ns"]
                         - log["gc_in_assemble_ns"]).mean())
