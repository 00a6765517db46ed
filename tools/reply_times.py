"""Time the native object reply, ``build_reply`` of csrc/reply.cpp, on the
host, for one or more copies of its source, and print one JSON line.

    python3 tools/reply_times.py [--names N] [--shapes 1000x10,5000x10]
        [--reps R] [--flush-mb M] [LABEL=]SOURCE ...

Each SOURCE is a reply.cpp (this package's by default), built with
native_reply.py's g++ command into ``build/native/`` and loaded as its own
module, so a parent's copy and the change's time in one process. Over
``--names`` names made as the benchmark makes them (``str(i)``, in an
object ndarray), each rep draws random int32 ids and float32 sims of each
shape ([B, k], no empty slots) and times one call of every source in
turns, the order reversed every other rep; ``--flush-mb`` MB are written
before each call, so the names do not start in cache from the call
before. Every source's reply is held against the first's (the same
names, objects and sims). Prints, per source and shape, the median and
quartiles of the ms a call and the median ns an answer, with the host's
CPU model.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from redis_hnsw_tpu_torch import native_reply  # noqa: E402


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def same_reply(a, b) -> bool:
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(
            x.name is y.name and x.sim == y.sim and x.data is y.data
            for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", default=[native_reply._SRC])
    ap.add_argument("--names", type=int, default=1_000_000)
    ap.add_argument("--shapes", default="1000x10,5000x10")
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--flush-mb", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    mods = []
    for item in args.sources:
        label, _, src = item.rpartition("=")
        mods.append((label or src, native_reply.build_module(
            os.path.abspath(src)).build_reply))
    names = np.array([str(i) for i in range(args.names)], object)
    flush = np.zeros(args.flush_mb << 17, np.float64)
    rng = np.random.default_rng(args.seed)
    out = {"cpu": cpu_model(), "names": args.names,
           "flush_mb": args.flush_mb, "reps": args.reps, "times": {}}
    for shape in args.shapes.split(","):
        b, k = map(int, shape.split("x"))
        ms = {label: [] for label, _ in mods}
        for rep in range(args.reps):
            ids = rng.integers(0, args.names, (b, k)).astype(np.int32)
            sims = -np.sort(rng.random((b, k)) * 4, axis=1).astype(np.float32)
            order = mods if rep % 2 == 0 else mods[::-1]
            first = None
            for label, build in order:
                flush += 1.0
                t0 = time.perf_counter_ns()
                reply = build(names, ids, sims)
                ms[label].append((time.perf_counter_ns() - t0) / 1e6)
                if first is None:
                    first = reply
                elif not same_reply(reply, first):
                    raise SystemExit(f"{label}: reply differs at {shape}")
                del reply
            del first
        out["times"][shape] = {
            label: {"median_ms": statistics.median(v),
                    "quartiles_ms": statistics.quantiles(v, n=4),
                    "ns_per_answer": 1e6 * statistics.median(v) / (b * k)}
            for label, v in ms.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
