"""What a window gives the harness, and what a finished run hands the
metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TraceData:
    """The traced window of a ``--trace 1`` run (bench_gpu/trace.py)."""

    window_s: float            # the traced window (its bench.window span)
    busy_s: float              # union of the device's operations in it
    device_events: int         # operations the profiler saw on the device
    port_kernel_s: float       # device time of the port's own kernels
    # per bound kernel (bounds/<kernel>.py): least seconds summed over its
    # launches, and the device seconds of the port kernels they launched
    least_s: dict = field(default_factory=dict)
    kernel_s: dict = field(default_factory=dict)
    # device seconds of port kernels launched outside every wrapped entry,
    # in all and by kernel name (the ten largest)
    unattributed_s: float = 0.0
    unattributed: dict = field(default_factory=dict)
    # host spans over the whole window, seconds each (set once it closes)
    spans_s: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    def unattributed_share(self) -> float:
        """The share of the port kernels' device time that no wrapped
        entry launched."""
        if self.port_kernel_s <= 0:
            return 0.0
        return self.unattributed_s / self.port_kernel_s

    def roofline_pct(self, kernel: str | None = None):
        """Least time over device time, in percent, of one bound kernel's
        launches, or of all the port's kernels (``None``: a kernel with
        no bound file counts in the denominator only). None where the
        window ran none."""
        if kernel is None:
            num, den = sum(self.least_s.values()), self.port_kernel_s
        else:
            num, den = self.least_s.get(kernel, 0.0), self.kernel_s.get(
                kernel, 0.0)
        if den <= 0 or num <= 0:
            return None
        return 100.0 * num / den


@dataclass
class Run:
    setup_s: float
    window_s: float            # first send to last reply, host clock
    latencies_s: list          # one a request; inf where it failed
    answered_queries: int      # queries of the requests that completed
    live_rows: int
    mem_peak_bytes: int | None  # the port's peak on the card, or None
    table_bytes: int | None = None    # FlatIndex._device() tensors
    counters: dict = field(default_factory=dict)  # deltas over the window
    trace: TraceData | None = None


@dataclass
class Window:
    """What the traffic driver (``loops/<loop>.py``) saw in the window."""

    latencies_s: list = field(default_factory=list)  # inf where it failed
    taken: list = field(default_factory=list)  # (pool request, ids, sims, bad)
    errors: list = field(default_factory=list)
    answered: int = 0
    failed: int = 0
    profiled: int = 0      # requests sent while the profiler ran
    requests: int = 0
    seconds: float = 0.0   # first send to last reply
    collections: list = field(default_factory=list)  # by generation
    trace: TraceData | None = None   # the profiled part
