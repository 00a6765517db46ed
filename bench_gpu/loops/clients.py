"""Many closed-loop clients, one query a request: ``clients`` threads of
this process, each sending ``search_batch`` of the request's queries
(one, as the mix must ask) and waiting for its reply before it sends the
next, for the window's seconds, as Redis's connections each send
``HNSW.SEARCH`` and wait (``server.py`` makes that call of one query for
``ENGINE AUTO``). The clients share one index and so its lock.

Each client takes the next request of the pool from a counter shared
under a lock, sends it, takes its checked answer as ``closed.py`` does,
and keeps its own latencies and answers; the window's are theirs put
together once every client has stopped. No client sends after the
window's end, every request sent is awaited, and the window's seconds
run from the first send to the last reply.

With a tracer, this thread starts the profiler ``TRACE_AT`` into the
window and stops it ``TRACE_S`` later at most, as ``closed.py`` does,
recording every thread's host events (the clients' spans and the port's
entries and annotations); the requests sent meanwhile count as
profiled."""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import time
from dataclasses import dataclass, field

from ..record import Window
from .closed import TRACE_AT, TRACE_S, take_sample


def refusal(traffic: dict) -> str | None:
    clients = int(traffic.get("clients", 1))
    if clients < 2:
        return (f"loop 'clients' drives two clients or more, the mix asks "
                f"for {clients}")
    if int(traffic["request_queries"]) != 1:
        return (f"loop 'clients' sends one query a request, the mix asks "
                f"for {traffic['request_queries']}")
    return None


@dataclass
class _Client:
    """What one client saw."""

    latencies_s: list = field(default_factory=list)
    taken: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    answered: int = 0
    failed: int = 0
    profiled: int = 0
    requests: int = 0
    last_reply: float = 0.0


def start_all_threads(tracer, cuda: bool) -> None:
    """``tracer.start`` with the profiler recording the host events of
    every thread, not only of the one that starts it."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    plain = torch.profiler.profile
    torch.profiler.profile = functools.partial(
        plain, experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    try:
        tracer.start(cuda)
    finally:
        torch.profiler.profile = plain


def serve(client, index: str, inputs, traffic: dict, seconds: float,
          tracer, cuda: bool, t0: float) -> Window:
    """Requests from every client for ``seconds``; see the module's
    docstring. ``t0`` is when the harness handed over."""
    import torch

    k, b = int(traffic["k"]), int(traffic["request_queries"])
    engine = traffic["engine"]
    n_pool = len(inputs.samples)
    pool, samples = inputs.pool, inputs.samples

    def span(name):
        if tracer is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    take_lock = threading.Lock()
    go = threading.Event()
    sent = 0
    tracing = False
    end = math.inf   # set before the clients go

    def next_request() -> int | None:
        """The next pool request, or None once the window has ended."""
        nonlocal sent
        if time.perf_counter() >= end:
            return None
        with take_lock:
            i = sent
            sent += 1
        return i % n_pool

    def loop(c: _Client) -> None:
        go.wait()
        while (pr := next_request()) is not None:
            q = pool[pr * b : (pr + 1) * b]
            c.profiled += tracing
            with span("bench.request"):
                ts = time.perf_counter()
                try:
                    reply = client.search_batch(index, q, k=k, engine=engine)
                except Exception as e:  # a failed request counts; go on
                    reply = None
                    if len(c.errors) < 3:
                        c.errors.append(f"request {pr}: {e!r}")
                c.last_reply = time.perf_counter()
            with span("bench.client"):
                ids, sims, bad, whole = take_sample(reply, samples[pr], k, b)
                c.taken.append((pr, ids, sims, bad))
                if whole:
                    c.latencies_s.append(c.last_reply - ts)
                    c.answered += b
                else:
                    c.latencies_s.append(math.inf)
                    c.failed += 1
                del reply
            c.requests += 1

    clients = [_Client() for _ in range(int(traffic["clients"]))]
    threads = [threading.Thread(target=loop, args=(c,), daemon=True,
                                name=f"bench-client-{i}")
               for i, c in enumerate(clients)]
    for t in threads:
        t.start()
    first = time.perf_counter()
    end = first + seconds
    go.set()
    w = Window()
    if tracer is not None:
        trace_from = first + TRACE_AT * seconds
        trace_len = min(TRACE_S, seconds / 2)
        time.sleep(max(0.0, trace_from - time.perf_counter()))
        tracing = True
        start_all_threads(tracer, cuda)
        time.sleep(trace_len)
        w.trace = tracer.stop()
        tracing = False
    for t in threads:
        t.join()
    for c in clients:
        w.latencies_s += c.latencies_s
        w.taken += c.taken
        w.errors += c.errors[: max(0, 3 - len(w.errors))]
        w.answered += c.answered
        w.failed += c.failed
        w.profiled += c.profiled
        w.requests += c.requests
    replies = [c.last_reply for c in clients if c.requests]
    w.seconds = max(replies) - first if replies else 0.0
    return w
