"""gc_pause_ms: the collector's pauses a request, every generation, in
ms: the port's own record of each ``search_batch`` (``gc_ns``, timed by
its ``gc.callbacks`` hook on the thread that triggered the collection),
over the window's requests outside the profiled part."""

from bench_gpu.request_log import mean_ms


def read(run):
    return mean_ms(run, "gc_ns")
