"""Where a graph-engine batch spends its time, on one CUDA card.

    python3 profile_graph.py [TRACE.json]

Run from the root of a checkout on a machine with an sm_90a card. Builds
chip_smoke.py's hnsw-main index (10,000 x 128 Gaussian rows, M=16,
efcon=200, seed 7, native host core) and serves its 2048 queries with
``engine="graph"`` at bench.py's operating point (ef=256, iters=20,
expand=16) on three frontier tiers: f32 blocks (the default at this
size), f16 blocks and row gathers (``REDIS_HNSW_TPU_NBRVEC_DTYPE=off``).
For each tier it prints the batch time by CUDA events (mean of 5 after a
warm-up) and the kernel-C launches per batch; for the f32 tier it traces
one batch with torch.profiler and prints device time by kernel, the
device's busy and idle share of the batch's wall time, and writes the
Chrome trace to TRACE.json when a path is given. The card's name and
power limit come first.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
EF, ITERS, EXPAND = 256, 20, 16


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
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_graph: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    import redis_hnsw_tpu_torch as h
    from redis_hnsw_tpu_torch.ops import cuda_gather

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

    for j, tier in enumerate(("f32", "f16", "off")):
        os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"] = tier
        client.delete_node("g", f"v{j}")  # a mutation rebuilds the tier
        serve()
        c0 = cuda_gather.fused_block_score.launches
        ms = batch_ms(serve)
        per = (cuda_gather.fused_block_score.launches - c0) / 6
        print(f"tier {tier}: {ms:.3f} ms per {n_q}-query batch "
              f"({n_q / ms * 1e3:.0f} qps), kernel C {per:.0f} launches "
              f"per batch", flush=True)
        if tier != "f32":
            continue
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [e for e in prof.key_averages() if device_us(e) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(device_us(e) for e in rows)
        if busy == 0:
            print("profiler: no device time recorded (not measured)")
            continue
        print(f"profiler, tier f32, one batch: wall {wall_us:.0f} us, "
              f"device busy {busy:.0f} us ({busy / wall_us:.1%}), idle "
              f"{1 - busy / wall_us:.1%}")
        for e in sorted(rows, key=device_us, reverse=True)[:25]:
            print(f"  {device_us(e):10.0f} us {e.count:6d}x  {e.key[:110]}")
        if len(sys.argv) > 1:
            os.makedirs(os.path.dirname(sys.argv[1]) or ".", exist_ok=True)
            prof.export_chrome_trace(sys.argv[1])
    del os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
