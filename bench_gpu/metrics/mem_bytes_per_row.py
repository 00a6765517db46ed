"""mem_bytes_per_row: the port's peak of allocated device memory
(torch.cuda.max_memory_allocated, reset before its first call on the
card and read when the window closes) over the index's live rows."""


def read(run):
    if run.mem_peak_bytes is None or run.live_rows <= 0:
        return None
    return run.mem_peak_bytes / run.live_rows
