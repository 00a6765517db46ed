"""Where a graph-engine batch spends its time, on one CUDA card.

    python3 profile_graph.py [TRACE.json] [--root DIR] [--label NAME]

Run from the root of a checkout on a machine with an sm_90a card.
``--root`` is the checkout whose package is profiled (this one by
default), so a parent unpacked by ``git archive`` can be profiled by the
same script. Builds chip_smoke.py's hnsw-main index (10,000 x 128
Gaussian rows, M=16, efcon=200, seed 7, native host core) and serves its
2048 queries with ``engine="graph"`` at bench.py's operating point
(ef=256, iters=20, expand=16) on three frontier tiers: f32 blocks (the
default at this size), f16 blocks and row gathers
(``REDIS_HNSW_TPU_NBRVEC_DTYPE=off``). For each tier it prints the batch
time by CUDA events (mean of 5 after a warm-up) and the kernel-C
launches per batch, then traces one batch with torch.profiler and prints
the device's busy and idle share of the batch's wall time, device time
by kernel, and the batch broken down by the pipeline's steps: host
(CPU) and device time of each call of the descent, the entry and seed
scoring (``_entry_sims``, the f16 tier's narrowing gather), the beam
(with its per-step sorts and kernel C) and the final rescore, each
wrapped in a ``record_function`` span for the trace only. With a path,
the f32 tier's Chrome trace is written there. The card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
EF, ITERS, EXPAND = 256, 20, 16
TIERS = ("f32", "f16", "off")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def batch_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def wrap_steps(search, distance):
    """Wrap the graph pipeline's steps in record_function spans named
    ``step:<function>``; returns the span names."""
    from torch.profiler import record_function

    spans = []

    def wrap(module, name):
        fn = getattr(module, name)

        @functools.wraps(fn)
        def inner(*a, **kw):
            with record_function(f"step:{name}"):
                return fn(*a, **kw)

        setattr(module, name, inner)
        spans.append(f"step:{name}")

    for name in ("greedy_descent", "_entry_sims", "_score", "beam_search",
                 "fused_block_score", "_sort_key_pid", "_inf_last"):
        wrap(search, name)
    for name in ("exact_neg_sq_l2", "resort_desc"):
        wrap(distance, name)
    return spans


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", nargs="?", default="")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_graph: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), args.label, flush=True)
    sys.path.insert(0, os.path.abspath(args.root))
    import redis_hnsw_tpu_torch as h
    from redis_hnsw_tpu_torch.ops import cuda_gather
    from redis_hnsw_tpu_torch.ops import distance as Dm
    from redis_hnsw_tpu_torch.ops import search as Sr

    n, dim, n_q = 10_000, 128, 2048
    rng = np.random.default_rng(SEED)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((n_q, dim)).astype(np.float32)
    client = h.HNSW()
    client.create_index("g", dim=dim, m=16, ef_construction=200, seed=SEED,
                        backend="native")
    for i in range(n):
        client.add_node("g", f"v{i}", data[i])

    def serve():
        return client.search_batch("g", qs, k=10, engine="graph",
                                   ef_search=EF, iters=ITERS, expand=EXPAND,
                                   reply="columnar")

    for j, tier in enumerate(TIERS):
        os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"] = tier
        client.delete_node("g", f"v{j}")  # a mutation rebuilds the tier
        serve()
        c0 = cuda_gather.fused_block_score.launches
        ms = batch_ms(serve)
        per = (cuda_gather.fused_block_score.launches - c0) / 6
        print(f"tier {tier}: {ms:.3f} ms per {n_q}-query batch "
              f"({n_q / ms * 1e3:.0f} qps), kernel C {per:.0f} launches "
              f"per batch", flush=True)
    spans = wrap_steps(Sr, Dm)
    from torch.profiler import ProfilerActivity, profile

    for j, tier in enumerate(TIERS):
        os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"] = tier
        client.delete_node("g", f"v{len(TIERS) + j}")
        serve()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        avg = prof.key_averages()
        rows = [e for e in avg if self_device_us(e) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("step:")]
        busy = sum(self_device_us(e) for e in rows)
        if busy == 0:
            print(f"profiler, tier {tier}: no device time recorded (not "
                  f"measured)")
            continue
        print(f"profiler, tier {tier}, one batch (with the step spans): "
              f"wall {wall_us:.0f} us, device busy {busy:.0f} us "
              f"({busy / wall_us:.1%}), idle {1 - busy / wall_us:.1%}")
        for e in sorted(rows, key=self_device_us, reverse=True)[:12]:
            print(f"  {self_device_us(e):10.0f} us {e.count:6d}x  "
                  f"{e.key[:100]}")
        # a span appears twice: on the host (its time, and the device
        # time of the torch kernels it launched) and on the device (the
        # time from its first kernel's start to its last's end)
        steps = {}
        for e in avg:
            if e.key in spans:
                row = steps.setdefault(e.key, [0, 0.0, 0.0, 0.0])
                row[0] = max(row[0], e.count)
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    row[3] += device_us(e)
                else:
                    row[1] += e.cpu_time_total
                    row[2] += device_us(e)
        print("  steps: calls, host ms, device ms of the torch kernels it "
              "launched, device ms spanned (kernel C's own launches count "
              "only there)")
        for key, (n, host, dev, span) in steps.items():
            print(f"    {key[5:]:18s} {n:5d}x  host {host / 1e3:8.3f}  "
                  f"device {dev / 1e3:8.3f}  spanned {span / 1e3:8.3f}")
        if args.trace and tier == "f32":
            os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
            prof.export_chrome_trace(args.trace)
    del os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
