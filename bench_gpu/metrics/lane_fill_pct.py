"""lane_fill_pct: of the query lanes the kernels computed for the
window's requests outside the profiled part, the share a query filled,
in percent: the port's record of each ``search_batch``, ``queries`` over
``scan_lanes`` (each launch computes ceil(B / tile) * tile lanes for its
B queries, ops/cuda_scan.py ``QUERY_TILE``). None where the record has
no ``scan_lanes`` field or counted none (the CPU launches no kernel)."""

from bench_gpu.request_log import window


def read(run):
    log = window(run)
    if log is None or "scan_lanes" not in log:
        return None
    lanes = int(log["scan_lanes"].sum())
    if lanes <= 0:
        return None
    return 100.0 * int(log["queries"].sum()) / lanes
