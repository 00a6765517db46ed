"""Wall-clock phase timing and device traces.

Port of ``redis_hnsw_tpu/utils/profiling.py``. Work on the card is
queued, so each ``PhaseTimer`` phase ends with
``torch.cuda.synchronize()`` once CUDA is in use: a phase's time then
covers the device work it queued, not only its enqueue.
``device_trace`` records an op- and kernel-level trace with
``torch.profiler`` (the JAX module's ``jax.profiler.trace``), written as
a Chrome trace that Perfetto or chrome://tracing open.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..config import resolve_device


class PhaseTimer:
    """Accumulates wall-clock per named phase, syncing the card."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(total, 4),
                "calls": self.counts[name],
                "mean_ms": round(total / self.counts[name] * 1e3, 3),
            }
            for name, total in sorted(
                self.totals.items(), key=lambda kv: -kv[1]
            )
        }


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """``torch.profiler`` trace around a block, written into ``log_dir``
    as ``trace-<pid>-<ns>.json`` (a Chrome trace). ``device`` is the
    device the traced work runs on (None = the card, which must be
    there): on a CUDA device the trace records the card's kernels
    (ProfilerActivity.CUDA) beside the host's ops, on the CPU the host's
    ops alone. Yields the profiler; its ``trace_path`` names the file
    once the block ends."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"
    )
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
    prof.trace_path = path
