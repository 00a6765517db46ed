"""Wall-clock phase timing.

Port of ``PhaseTimer`` from ``redis_hnsw_tpu/utils/profiling.py``. Work on
the card is queued, so each phase ends with ``torch.cuda.synchronize()``
once CUDA is in use: a phase's time then covers the device work it
queued, not only its enqueue. (The JAX module's ``device_trace`` is not
ported yet, ROADMAP queue 1 item 11.)
"""

from __future__ import annotations

import contextlib
import time

import torch


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
