"""One closed-loop client: it sends the next request as soon as the reply
to the last is back, for the window's seconds. Each request's queries are
the next block of the pool (``request_queries`` rows each), and its
checked answers are taken once its reply is back. With a tracer, the
profiler covers the requests sent from ``TRACE_AT`` of the window on, for
at most ``TRACE_S`` seconds."""

from __future__ import annotations

import contextlib
import math
import time

from ..record import Window

TRACE_AT = 0.25     # the profiler starts a quarter into the window
TRACE_S = 4.0       # and covers requests sent over this long at most


def refusal(traffic: dict) -> str | None:
    if int(traffic.get("clients", 1)) != 1:
        return (f"loop 'closed' drives one client, the mix asks for "
                f"{traffic['clients']}")
    return None


def take_sample(reply, rows, k: int, b: int):
    """The checked answers of one request: (ids, sims, bad) of the query
    rows ``rows``, and whether the whole reply had its form (b answers of
    k results each)."""
    import numpy as np

    m = len(rows)
    ids = np.full((m, k), -1, np.int64)
    sims = np.full((m, k), np.nan)
    bad = np.zeros(m, bool)
    if not isinstance(reply, list) or len(reply) != b:
        bad[:] = True
        return ids, sims, bad, False
    whole = all(len(res) == k for res in reply)
    for j, qi in enumerate(rows):
        res = reply[qi]
        if len(res) != k:
            bad[j] = True
            continue
        try:
            ids[j] = [int(r.name) for r in res]
            sims[j] = [r.sim for r in res]
        except (AttributeError, TypeError, ValueError):
            bad[j] = True
    return ids, sims, bad, whole


def serve(client, index: str, inputs, traffic: dict, seconds: float,
          tracer, cuda: bool, t0: float) -> Window:
    """Requests from ``t0`` for ``seconds``; see the module's docstring."""
    import torch

    k, b = int(traffic["k"]), int(traffic["request_queries"])
    engine = traffic["engine"]

    def span(name):
        if tracer is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    w = Window()
    n_pool = len(inputs.samples)
    traced = 0  # 0 before the profiled part, 1 in it, 2 after
    t_done = t0
    t_end = t0 + seconds
    trace_from = t0 + TRACE_AT * seconds
    trace_len = min(TRACE_S, seconds / 2)
    while time.perf_counter() < t_end:
        if tracer and traced == 0 and time.perf_counter() >= trace_from:
            tracer.start(cuda)
            traced, t_traced = 1, time.perf_counter()
        pr = w.requests % n_pool
        q = inputs.pool[pr * b : (pr + 1) * b]
        with span("bench.request"):
            ts = time.perf_counter()
            try:
                reply = client.search_batch(index, q, k=k, engine=engine)
            except Exception as e:  # a failed request counts; the window goes on
                reply = None
                if len(w.errors) < 3:
                    w.errors.append(f"request {w.requests}: {e!r}")
            t_done = time.perf_counter()
        with span("bench.client"):
            ids, sims, bad, whole = take_sample(reply, inputs.samples[pr],
                                                k, b)
            w.taken.append((pr, ids, sims, bad))
            if whole:
                w.latencies_s.append(t_done - ts)
                w.answered += b
            else:
                w.latencies_s.append(math.inf)
                w.failed += 1
            del reply
        w.requests += 1
        w.profiled += traced == 1
        if traced == 1 and time.perf_counter() >= t_traced + trace_len:
            w.trace, traced = tracer.stop(), 2
    if traced == 1:
        w.trace = tracer.stop()
    w.seconds = t_done - t0
    return w
