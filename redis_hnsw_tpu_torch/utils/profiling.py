"""The port's tracing: spans, counters, the per-request record, device
traces.

**Spans** time a named piece of work on the host clock
(``time.perf_counter_ns``), with no device sync: ``with span("dispatch"):``.
A span's time is its SELF time: spans opened inside it on the same
thread are taken off it (a ``finish`` holds ``card_wait`` spans, and
counts only the time outside them). Every span adds to a process-wide
registry (:func:`totals`), whatever the thread.

**Counters** are plain integer increments of the open record's fields
(:func:`count`).

**The per-request record.** ``HNSW.search_batch`` opens one record a
call on its thread (:func:`request`) and writes it when the call ends,
a failed call too, into a fixed ring of RING_ROWS rows, a numpy array
made once. Spans and counters anywhere below, on the same thread, add
to the open record: the fields of :data:`FIELDS`, times in ns. The ring
is process-wide (every client and index of the process);
:func:`recent` reads the newest records. Nothing a request does here
leaves an object for the collector to walk: the record is a list of
ints made once a thread, the ring a preallocated array.

**Collector pauses.** The first request registers one ``gc.callbacks``
hook (never an import). Each collection's pause goes to the record open
on the thread that triggered it (``gc_ns``, and ``gc_in_assemble_ns``
when it fell inside the ``assemble`` span), and to process-wide totals
by generation (:func:`gc_totals`).

**One clock with the device trace.** While a ``torch.profiler`` records,
each span also opens ``record_function("hnsw.<span>")``, a request
``hnsw.request`` and a collection ``hnsw.gc.<generation>``: host events on
the profiler's clock, so its idle gaps can be named by the program's
spans. With no profiler, no annotation is made.

``device_trace`` records an op- and kernel-level trace with
``torch.profiler`` (the JAX module's ``jax.profiler.trace``), written as
a Chrome trace that Perfetto or chrome://tracing open.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from time import perf_counter_ns

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from ..config import resolve_device

# The record's fields, int64 each. Times in ns: ``request_ns`` from entry
# to return, then the self time of each span of that name
# (``lock_wait``: asking for the per-index lock to holding it, or to a
# holder taking the request into its block; ``block_wait``: from then
# until the block's holder handed its rows over, api.py ``IndexLock``;
# ``prepare``: the queries coerced and the device tables or snapshot;
# ``dispatch``: the chunks' dispatch halves and their windows' copies
# queued; ``card_wait``: the host blocked on the card; ``finish``: the
# finish halves outside their card waits; ``rerun``: the certified tier's
# deferred reruns; ``assemble``: the reply's objects); ``gc_ns``: the
# collector's pauses, ``gc_in_assemble_ns`` the part inside ``assemble``.
# Counts: collections (full ones apart), queries, chunks, the certified
# tier's queries and those it served again on the exact tier (ops/scan.py
# CERT_STATS keys of the same names), those a failing certificate left to
# the exact tier (``cert_skipped_queries``: CERT_STATS
# ``skipped_queries``, ops/scan.py CertHistory), the queries the exact
# tier served first-hand (``exact_queries``: kernel A or A′ alone, the
# approx tier included; ops/scan.py ``serve_block`` and the flat kind's
# whole-block path), the queries whose object reply ``build_reply`` made
# (ops/search.py ``reply_objects``); ``lock_waiters``: the other callers
# that held or waited for the index's lock as this one began to wait
# (api.py ``IndexLock``); ``block_requests``: the requests the one
# search that served this one answered, this one included (1 where it
# was served alone; api.py ``HNSW.search_batch``); ``scan_lanes``: the
# query lanes the kernels launched for it computed, ceil(B / tile) *
# tile a launch whose grid tiles its B queries (ops/cuda_scan.py
# ``count_lanes``; none on the CPU); ``failed`` 1 where the call
# raised, ``profiled`` 1 where a torch.profiler recorded as it began;
# ``start_ns`` its perf_counter_ns at entry.
FIELDS = (
    "start_ns", "request_ns", "lock_wait_ns", "block_wait_ns", "prepare_ns",
    "dispatch_ns", "card_wait_ns", "finish_ns", "rerun_ns", "assemble_ns",
    "gc_ns", "gc_in_assemble_ns", "gc_count", "gc_full", "queries", "chunks",
    "cert_queries", "whole_batch_queries", "cert_skipped_queries",
    "rerun_queries", "audit_queries", "exact_queries",
    "native_reply_queries", "lock_waiters", "block_requests", "scan_lanes",
    "failed", "profiled",
)
COL = {name: i for i, name in enumerate(FIELDS)}
# 262,144 records (~59 MB of zero pages, made once): a 40 s window of
# 6,500 requests a second
RING_ROWS = 1 << 18

_RING = np.zeros((RING_ROWS, len(FIELDS)), np.int64)
_ZERO = (0,) * len(FIELDS)
_START, _REQUEST, _FAILED, _PROFILED = (
    COL["start_ns"], COL["request_ns"], COL["failed"], COL["profiled"])
_GC, _GC_IN_ASSEMBLE, _GC_COUNT, _GC_FULL = (
    COL["gc_ns"], COL["gc_in_assemble_ns"], COL["gc_count"], COL["gc_full"])

# Shared state: the ring's write count, the spans' registry. The gc
# totals take no lock: only the gc hook writes them, and one collection
# runs at a time in a process.
_LOCK = threading.Lock()
_WRITTEN = [0]
_GC_NS = [0, 0, 0]
_GC_N = [0, 0, 0]
_HOOKED = [False]


def _profiling() -> bool:
    """Is a torch.profiler recording (autograd's flag, set by every
    ``torch.profiler.profile``)?"""
    return _autograd_profiler._is_profiler_enabled


class _State:
    """One thread's open spans (parallel stacks: span, start, time of the
    spans nested in it, annotation) and its record."""

    __slots__ = ("spans", "t0", "kids", "ann", "rec", "depth", "req_ann",
                 "gc_t0", "gc_ann")

    def __init__(self) -> None:
        self.spans: list = []
        self.t0: list = []
        self.kids: list = []
        self.ann: list = []
        self.rec = list(_ZERO)
        self.depth = 0          # open requests (nested calls add none)
        self.req_ann = None
        self.gc_t0 = 0
        self.gc_ann = None


class _Local(threading.local):
    def __init__(self) -> None:
        self.s = _State()


_TLS = _Local()


def _annotation(label: str):
    rf = torch.profiler.record_function(label)
    rf.__enter__()
    return rf


class _Span:
    """A named span, one object a name, shared by every thread (its
    state is the thread's): ``with span(name):``. ``ns`` and ``n`` are the
    registry's self time and count."""

    __slots__ = ("name", "label", "col", "ns", "n")

    def __init__(self, name: str) -> None:
        self.name = name
        self.label = "hnsw." + name
        self.col = COL.get(name + "_ns", -1)
        self.ns = 0
        self.n = 0

    def __enter__(self):
        st = _TLS.s
        st.spans.append(self)
        st.ann.append(_annotation(self.label) if _profiling() else None)
        st.kids.append(0)
        st.t0.append(perf_counter_ns())
        return self

    def __exit__(self, et, ev, tb) -> None:
        dt = perf_counter_ns()
        st = _TLS.s
        dt -= st.t0.pop()
        own = dt - st.kids.pop()
        st.spans.pop()
        rf = st.ann.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if st.kids:
            st.kids[-1] += dt
        if st.depth and self.col >= 0:
            st.rec[self.col] += own
        with _LOCK:
            self.ns += own
            self.n += 1


_SPANS: dict = {}


def span(name: str) -> _Span:
    """The span ``name`` (``with span(name):``); the record's field
    ``<name>_ns`` takes its self time where the record has one."""
    s = _SPANS.get(name)
    if s is None:
        with _LOCK:
            s = _SPANS.setdefault(name, _Span(name))
    return s


def count(field: str, n: int) -> None:
    """Add ``n`` to the record field ``field`` of the request open on this
    thread (none open: nothing)."""
    st = _TLS.s
    if st.depth:
        st.rec[COL[field]] += n


def shift(src: str, dst: str, ns: int) -> None:
    """Move ``ns`` of span ``src``'s self time to span ``dst`` (one more
    closing of it), in the open record and the registry: a wait that one
    wake-up ends, split at a moment another thread marked."""
    a, b = span(src), span(dst)
    st = _TLS.s
    if st.depth:
        st.rec[a.col] -= ns
        st.rec[b.col] += ns
    with _LOCK:
        a.ns -= ns
        b.ns += ns
        b.n += 1


def totals() -> dict:
    """{span name: (self ns, times closed)} over the process's life."""
    with _LOCK:
        return {name: (s.ns, s.n) for name, s in _SPANS.items()}


def gc_totals() -> dict:
    """The collector's pauses over the process's life since the hook was
    registered: ``ns`` and ``count`` by generation (lists of three);
    ``count[2]`` is the full collections."""
    return {"ns": list(_GC_NS), "count": list(_GC_N)}


def _on_gc(phase: str, info: dict) -> None:
    st = getattr(_TLS, "s", None)
    if st is None:  # set off while this thread's state was being made
        return
    if phase == "start":
        if _profiling():
            st.gc_ann = _annotation(f"hnsw.gc.{info['generation']}")
        st.gc_t0 = perf_counter_ns()
        return
    dt = perf_counter_ns() - st.gc_t0
    if st.gc_ann is not None:
        st.gc_ann.__exit__(None, None, None)
        st.gc_ann = None
    gen = info["generation"]
    _GC_NS[gen] += dt
    _GC_N[gen] += 1
    if st.depth:
        rec = st.rec
        rec[_GC] += dt
        rec[_GC_COUNT] += 1
        rec[_GC_FULL] += gen == 2
        if st.spans and st.spans[-1] is _ASSEMBLE:
            rec[_GC_IN_ASSEMBLE] += dt


_ASSEMBLE = span("assemble")


class _Request:
    """``with request():`` around one ``HNSW.search_batch`` call: opens
    this thread's record (a call inside an open one adds to it) and
    writes it into the ring when the block ends, ``failed`` set where it
    raised. The first request registers the collector hook."""

    __slots__ = ()

    def __enter__(self):
        if not _HOOKED[0]:
            with _LOCK:
                if not _HOOKED[0]:
                    gc.callbacks.append(_on_gc)
                    _HOOKED[0] = True
        st = _TLS.s
        st.depth += 1
        if st.depth == 1:
            prof = _profiling()
            st.req_ann = _annotation("hnsw.request") if prof else None
            st.rec[_PROFILED] = int(prof)
            st.rec[_START] = perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb) -> None:
        st = _TLS.s
        if st.depth > 1:
            st.depth -= 1
            return
        rec = st.rec
        rec[_REQUEST] = perf_counter_ns() - rec[_START]
        rec[_FAILED] = int(et is not None)
        if st.req_ann is not None:
            st.req_ann.__exit__(None, None, None)
            st.req_ann = None
        with _LOCK:
            _RING[_WRITTEN[0] % RING_ROWS] = rec
            _WRITTEN[0] += 1
        rec[:] = _ZERO
        st.depth = 0


_REQUEST_CM = _Request()


def request() -> _Request:
    """The per-request record's context (``with request():``)."""
    return _REQUEST_CM


def recent(n: int) -> dict:
    """The newest ``n`` records (at most RING_ROWS, fewer where fewer were
    written), oldest first: {field: int64 array} over :data:`FIELDS`."""
    with _LOCK:
        m = max(0, min(int(n), _WRITTEN[0], RING_ROWS))
        rows = _RING[np.arange(_WRITTEN[0] - m, _WRITTEN[0]) % RING_ROWS]
    return {name: rows[:, i] for i, name in enumerate(FIELDS)}


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """``torch.profiler`` trace around a block, written into ``log_dir``
    as ``trace-<pid>-<ns>.json`` (a Chrome trace). ``device`` is the
    device the traced work runs on (None = the card, which must be
    there): on a CUDA device the trace records the card's kernels
    (ProfilerActivity.CUDA) beside the host's ops, on the CPU the host's
    ops alone; the port's ``hnsw.*`` spans are among the host's events.
    Yields the profiler; its ``trace_path`` names the file once the
    block ends."""
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
