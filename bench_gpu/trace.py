"""Spans, launch records and the device trace of a ``--trace 1`` run.

Spans come from the benchmark's own files: :class:`Tracer` wraps the
port's functions by replacing them, in every module of the port that
holds them, with a recorder that calls the original. It wraps

* each hand-written kernel's Python entry named by a ``bounds/<kernel>.py``
  file, recording the launch's least time (operations over the peak of
  its ``PEAK``, or bytes over the HBM bandwidth, whichever is longer)
  and marking the call as the profiler span ``bench.kernel.<kernel>``;
* ``ops/search.py`` ``assemble``, the reply assembly, timed on the host
  clock as the span ``assemble``.

A recorder forwards attribute reads and writes to the original, so the
entries' own ``.launches`` counters count as before.

The profiler (``torch.profiler``, host ops and the card's operations)
covers a steady part of the window (:meth:`Tracer.start` /
:meth:`Tracer.stop`); its events are read in memory and reduced to a
:class:`~bench_gpu.record.TraceData`: the busy union of the device's
operations, the port kernels' device time (each launch attributed to the
entry span its runtime call ran in, by the profiler's correlation ids),
and the breakdown (the device operations that took most time, the idle
gaps by the host span that was open).

Every hand-written kernel of the port has a bound file, so each of its
launches runs inside a wrapped entry. A launch that does not (an entry
that a later change binds into a partial, a closure or a table before
the wrapper is installed, or a new kernel without a bound file) is
counted apart, ``TraceData.unattributed_s``; above ``UNATTRIBUTED_MAX``
of the port kernels' device time the traced run gives no result
(``bench_gpu/run.py``), since the per-kernel rooflines would then read
only part of their kernel's launches.
"""

from __future__ import annotations

import bisect
import glob
import importlib
import os
import re
import sys
import time

import torch

from .record import TraceData
from .spec import load_file

PORT = "redis_hnsw_tpu_torch"
ASSEMBLE = "redis_hnsw_tpu_torch.ops.search:assemble"
HERE = os.path.dirname(os.path.abspath(__file__))
TOP = 10
UNATTRIBUTED_MAX = 0.01   # share of the port kernels' device time


def load_bounds(root: str = HERE) -> dict:
    """{kernel: module} of every ``bounds/<kernel>.py``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "bounds", "*.py"))):
        name = os.path.basename(path)[:-3]
        if not name.startswith("_"):
            out[name] = load_file(path, f"bench_gpu_bound_{name}")
    return out


def port_kernel_names() -> list[str]:
    """The ``__global__`` functions of the port's CUDA sources."""
    import redis_hnsw_tpu_torch

    csrc = os.path.join(os.path.dirname(redis_hnsw_tpu_torch.__file__),
                        "csrc")
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu*")):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    return sorted(names)


def least_seconds(bound, peaks: dict, *args, **kwargs) -> float:
    ops, nbytes = bound.cost(*args, **kwargs)
    return max(ops / peaks[bound.PEAK], nbytes / peaks["hbm_bytes"])


def resolve(entry: str):
    mod, fn = entry.split(":")
    return getattr(importlib.import_module(mod), fn)


class _Recorder:
    """Stands in for one function of the port."""

    def __init__(self, fn, on_call):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_on_call", on_call)

    def __call__(self, *args, **kwargs):
        return self._on_call(self._fn, args, kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Tracer:
    def __init__(self, peaks: dict, bounds: dict | None = None):
        self.peaks = peaks
        self.bounds = load_bounds() if bounds is None else bounds
        self.kernel_re = re.compile(
            r"(?<![A-Za-z0-9_])(" + "|".join(port_kernel_names())
            + r")(?![A-Za-z0-9_])")
        self.recording = False
        self.least_s: dict = {}
        self.spans_s: dict = {"assemble": []}
        self._undo: list = []
        self._prof = None

    # -- wrapping the port's functions ------------------------------------

    def _replace(self, fn, rec) -> None:
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == PORT or name.startswith(PORT + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is fn:
                    setattr(mod, attr, rec)
                    self._undo.append((mod, attr, fn))

    def install(self) -> None:
        for kernel, bound in self.bounds.items():
            self._replace(resolve(bound.ENTRY),
                          _Recorder(resolve(bound.ENTRY),
                                    self._kernel_call(kernel, bound)))
        self._replace(resolve(ASSEMBLE),
                      _Recorder(resolve(ASSEMBLE), self._assemble_call))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    def _kernel_call(self, kernel, bound):
        def call(fn, args, kwargs):
            if not self.recording:
                return fn(*args, **kwargs)
            with torch.profiler.record_function("bench.kernel." + kernel):
                out = fn(*args, **kwargs)
            self.least_s[kernel] = self.least_s.get(kernel, 0.0) + (
                least_seconds(bound, self.peaks, *args, **kwargs))
            return out
        return call

    def _assemble_call(self, fn, args, kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.assemble"):
            out = fn(*args, **kwargs)
        if not self.recording:  # the profiler's own cost stays out
            self.spans_s["assemble"].append(time.perf_counter() - t0)
        return out

    # -- the profiled part of the window ----------------------------------

    @staticmethod
    def _activities(cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self, cuda: bool) -> None:
        """One profiled op in set-up: the profiler's first start on the
        card (CUPTI's set-up) takes seconds, which would otherwise fall
        into the window."""
        with torch.profiler.profile(activities=self._activities(cuda)):
            x = torch.ones(8, device="cuda" if cuda else "cpu")
            (x + x).sum().item()

    def start(self, cuda: bool) -> None:
        if cuda:
            torch.cuda.synchronize()
        self._cuda = cuda
        self._prof = torch.profiler.profile(activities=self._activities(cuda))
        self._prof.__enter__()
        self._win = torch.profiler.record_function("bench.window")
        self._win.__enter__()
        self.recording = True

    def stop(self) -> TraceData:
        if self._cuda:
            torch.cuda.synchronize()
        self.recording = False
        self._win.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return self._reduce(events)

    def _reduce(self, events) -> TraceData:
        """The trace's window is the ``bench.window`` span; the device's
        operations are clipped to it."""
        cuda_type = torch.autograd.DeviceType.CUDA
        device, host, spans, runtime = [], [], [], {}
        ws = we = None
        for ev in events:
            s, d, name = _ns(ev, "start"), _ns(ev, "duration"), ev.name()
            if ev.device_type() == cuda_type:
                if not name.startswith("bench."):  # annotations, not work
                    device.append((s, s + d, name, ev.correlation_id()))
            elif name == "bench.window":
                ws, we = s, s + d
            elif name.startswith("bench."):
                spans.append((s, s + d, name))
            else:
                host.append((s, s + d, name))
                if name.startswith("cu") and ev.correlation_id():
                    runtime[ev.correlation_id()] = s
        if ws is None:
            raise RuntimeError("the trace has no bench.window span")
        spans.sort()
        host.sort()
        kspans = [(s, e, n[len("bench.kernel."):]) for s, e, n in spans
                  if n.startswith("bench.kernel.")]
        kstarts = [s for s, _, _ in kspans]

        def entry_of(corr):
            t = runtime.get(corr)
            i = bisect.bisect_right(kstarts, t) - 1 if t is not None else -1
            if i >= 0 and kspans[i][0] <= t <= kspans[i][1]:
                return kspans[i][2]
            return None

        port_ns, kernel_ns, by_name, lost = 0, {}, {}, {}
        intervals = []
        for s, e, name, corr in device:
            s, e = max(s, ws), min(e, we)
            if e <= s:
                continue
            intervals.append((s, e))
            by_name[name] = by_name.get(name, 0) + (e - s)
            if self.kernel_re.search(name):
                port_ns += e - s
                k = entry_of(corr)
                if k is not None:
                    kernel_ns[k] = kernel_ns.get(k, 0) + (e - s)
                else:
                    lost[name] = lost.get(name, 0) + (e - s)
        busy = _union(intervals)
        busy_ns = sum(e - s for s, e in busy)
        gaps, t = [], ws
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if we > t:
            gaps.append((t, we))
        idle: dict = {}
        span_starts = [s for s, _, _ in spans]
        host_starts = [s for s, _, _ in host]
        for s, e in gaps:
            label = self._host_at((s + e) // 2, spans, span_starts, host,
                                  host_starts)
            idle[label] = idle.get(label, 0) + (e - s)
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return TraceData(
            window_s=(we - ws) * 1e-9,
            busy_s=busy_ns * 1e-9,
            device_events=len(device),
            port_kernel_s=port_ns * 1e-9,
            least_s=dict(self.least_s),
            kernel_s={k: v * 1e-9 for k, v in kernel_ns.items()},
            unattributed_s=sum(lost.values()) * 1e-9,
            unattributed={n[:160]: v * 1e-9 for n, v in sorted(
                lost.items(), key=lambda kv: -kv[1])[:TOP]},
            breakdown={
                "device_ops": [[n[:160], v * 1e-9] for n, v in top_ops],
                "idle_gaps": [[n[:160], v * 1e-9] for n, v in top_idle],
            },
        )

    @staticmethod
    def _innermost(t, events, starts, reach):
        """The latest-starting of the ``reach`` events starting last
        before ``t`` that still runs at ``t``."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - reach), -1):
            if events[j][1] >= t:
                return events[j][2]
        return None

    def _host_at(self, t, spans, span_starts, host, host_starts) -> str:
        span = self._innermost(t, spans, span_starts, 64) or "outside spans"
        op = self._innermost(t, host, host_starts, 64) or "python"
        return f"{span} | {op}"
