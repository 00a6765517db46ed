"""drain_host_ms: the host's own ms a request in the chunk loop: the
port's ``dispatch``, ``finish`` and ``rerun`` spans, each outside the
card waits inside it, from the port's record of each ``search_batch``,
over the window's requests outside the profiled part."""

from bench_gpu.request_log import mean_ms


def read(run):
    return mean_ms(run, "dispatch_ns", "finish_ns", "rerun_ns")
