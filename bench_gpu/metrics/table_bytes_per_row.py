"""table_bytes_per_row: bytes of the device tensors FlatIndex._device()
returns (table, sqnorms, live mask, scales) over the live rows."""


def read(run):
    if run.trace is None or not run.table_bytes or run.live_rows <= 0:
        return None
    return run.table_bytes / run.live_rows
