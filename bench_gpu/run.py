"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m bench_gpu.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes the cell's base rows and
queries on the card from ``--seed`` with the configuration's generator
(``gen/<kind>.py``), loads the rows into a flat index of
``redis_hnsw_tpu_torch`` through its client (``HNSW``), serves the
traffic mix's warm-up requests, then lets the mix's traffic driver
(``loops/<loop>.py``) send requests for ``--seconds`` seconds, from a
query pool drawn before the window and sized to the window
(``pool_rate_per_s`` requests a second). The program runs as it ships:
the harness only collects set-up's garbage before the window. Once the
window has closed it frees the port's state and holds a sample of the
answers, drawn from the seed, against the plain reference of the
configuration's metric (``reference/<metric>.py``).

Standard output's last line is one JSON object: ``correct``,
``attempted`` and ``failed`` (requests), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each
read by ``metrics/<name>.py``), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also standard error's last lines. Exits 2 without a
result where there is no card or fewer than the cell asks for, 3 where
JAX or the JAX package was loaded, and 4 where a traced run saw the
port's kernels launched outside the entries it wraps (bench_gpu/trace.py).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "redis_hnsw_tpu")
INDEX = "bench"


def loaded_forbidden() -> list[str]:
    """Modules of JAX or the JAX package in this process, by top-level
    name compared whole (the port's name begins with the package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def pin_caches(root: str = spec.ROOT) -> None:
    """Kernel and extension caches at fixed paths inside the checkout
    (the port builds its own kernels into ``build/`` there)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", sub)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi not read ({e})"
    return ("card (name, power limit, SM clock, max SM clock): "
            + out.stdout.strip().splitlines()[0])


def pool_requests(traffic: dict, seconds: float) -> int:
    """Requests in the query pool: the window's seconds at the mix's
    ``pool_rate_per_s``, a rate above what the program reaches, so that no
    query repeats within a window (stderr counts any wrap)."""
    return max(1, math.ceil(seconds * float(traffic["pool_rate_per_s"])))


def check_answers(inputs, taken, metric: str, n: int, k: int, b: int,
                  device) -> dict:
    """The comparison's numbers over the checked answers of the window's
    requests (``taken``: (pool request, ids, sims, bad) each), against the
    reference of ``metric``."""
    import numpy as np
    import torch

    from .reference import compare

    ref = importlib.import_module(spec.part("reference", metric))

    if not taken:
        return {"bad_answers": 0, "sim_err": 0.0, "rank_gap": 0.0}
    req = np.array([t[0] for t in taken])
    qidx = (req[:, None] * b + inputs.samples[req]).ravel()
    ids = np.concatenate([t[1] for t in taken])
    sims = np.concatenate([t[2] for t in taken])
    bad = np.concatenate([t[3] for t in taken])
    rows = torch.from_numpy(inputs.rows).to(device)
    qs = torch.from_numpy(inputs.pool[qidx]).to(device)
    _, dist = ref.knn(rows, qs, k, "fp64")
    safe = torch.from_numpy(np.clip(ids, 0, n - 1)).to(device)
    d_named = ref.pair_dist(rows, qs, safe).cpu().numpy()
    return compare.readings(ids, sims, bad, d_named, ref.similarity(d_named),
                            dist[:, -1].cpu().numpy(), n)


def latency_line(lat: list) -> str:
    """min, quartiles, p95 and max of the window's latencies (ms)."""
    if not lat:
        return "none"
    xs = sorted(lat)

    def at(p):
        return xs[max(0, math.ceil(p * len(xs)) - 1)] * 1e3

    return json.dumps({"min": xs[0] * 1e3, "p25": at(0.25), "p50": at(0.5),
                       "p75": at(0.75), "p95": at(0.95), "max": xs[-1] * 1e3})


def read_metrics(entries: list, run) -> dict:
    out = {}
    for m in entries:
        reader = spec.load_file(spec.metric_path(m["name"]),
                           "bench_gpu_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def make_inputs(cell: spec.Cell, seed: int, dev, n_pool: int):
    """The cell's inputs from the seed, by the configuration's generator,
    with a pool of ``n_pool`` requests."""
    gen = importlib.import_module(
        spec.part("gen", cell.config["generator"]["kind"]))
    return gen.make_inputs(cell.config, cell.traffic, seed, dev, n_pool)


def set_up(cell: spec.Cell, seed: int, seconds: float, dev, steps: dict):
    """Inputs from the seed, the flat index loaded through the client, the
    warm-up requests served. Returns (client, index, inputs)."""
    import torch

    from redis_hnsw_tpu_torch import HNSW

    cfg, mix = cell.config, cell.traffic
    n, b = int(cfg["rows"]), int(mix["request_queries"])
    cuda = dev.type == "cuda"

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    if cuda:
        from redis_hnsw_tpu_torch.utils.build import build_kernels

        build_kernels()
    t = step("kernels", t)
    inputs = make_inputs(cell, seed, dev, pool_requests(mix, seconds))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t = step("inputs", t)
    client = HNSW(device=dev)
    index = client.create_index(INDEX, dim=int(cfg["dim"]),
                                metric=cfg["metric"], capacity=n,
                                kind="flat")
    client.add_batch(INDEX, [str(i) for i in range(n)], inputs.rows)
    t = step("add_batch", t)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for lo in range(0, len(inputs.warm), b):
        client.search_batch(INDEX, inputs.warm[lo : lo + b],
                            k=int(mix["k"]), engine=mix["engine"])
    if cuda:
        torch.cuda.synchronize()
    step("warmup", t)
    return client, index, inputs


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None):
    """Set up, serve the window, check. Returns (result, stderr lines);
    the result is None where the run may not give one."""
    import torch

    from redis_hnsw_tpu_torch.ops import scan as port_scan

    from .record import Run
    from .reference import compare
    from .trace import UNATTRIBUTED_MAX, Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    n, k, b = int(cfg["rows"]), int(mix["k"]), int(mix["request_queries"])
    steps = {"imports": time.perf_counter() - t_start}
    loop = importlib.import_module(spec.part("loops", mix["loop"]))
    client, index, inputs = set_up(cell, seed, seconds, dev, steps)
    tracer = None
    if trace:
        tracer = Tracer(spec.load_peaks())
        tracer.warm(cuda)
        tracer.install()
    # set-up's garbage goes before the window, so that every run's window
    # starts from the same collector state; the program's own objects stay
    # in the collector's generations, as they do in any client's process
    gc.collect()
    gc0 = [g["collections"] for g in gc.get_stats()]
    stats0 = dict(port_scan.CERT_STATS)
    t0 = time.perf_counter()
    w = loop.serve(client, INDEX, inputs, mix, seconds, tracer, cuda, t0)
    w.collections = [g["collections"] - c
                     for g, c in zip(gc.get_stats(), gc0)]
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    stats1 = dict(port_scan.CERT_STATS)
    table_bytes = None
    if tracer:
        tracer.uninstall()
        if w.trace is not None:
            w.trace.spans_s = tracer.spans_s
        table_bytes = sum(x.numel() * x.element_size()
                          for x in index._device() if x is not None)
    card = card_line() if cuda else "card: none (cpu run)"
    del client, index
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = check_answers(inputs, w.taken, cfg["metric"], n, k, b, dev)
    check_s = time.perf_counter() - t
    ok, checks = compare.judge(values, cfg["limits"])
    run = Run(
        setup_s=t0 - t_start, window_s=w.seconds,
        latencies_s=w.latencies_s, answered_queries=w.answered,
        live_rows=n, mem_peak_bytes=mem_peak, table_bytes=table_bytes,
        counters={
            "cert_queries": stats1["queries"] - stats0["queries"],
            "cert_fallback_queries": (stats1["fallback_queries"]
                                      - stats0["fallback_queries"]),
            "requests_unprofiled": w.requests - w.profiled,
        },
        trace=w.trace,
    )
    result = {
        "correct": bool(ok and w.failed == 0 and w.requests),
        "attempted": w.requests,
        "failed": w.failed,
        "metrics": read_metrics(cell.per_layer if trace else cell.end_to_end,
                                run),
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(mem_peak or 0),
        },
    }
    if w.trace is not None:
        result["device"]["busy_s"] = w.trace.busy_s
        result["device"]["window_s"] = w.trace.window_s
        result["breakdown"] = w.trace.breakdown
    result["checks"] = checks
    n_pool = len(inputs.samples)
    lines = [
        card,
        "setup (s): " + json.dumps(steps),
        "latency (ms): " + latency_line(w.latencies_s),
        f"window: {w.requests} requests of {b} queries in {w.seconds!r} s, "
        f"{w.answered} queries answered, {w.failed} failed, pool of "
        f"{n_pool} requests wrapped {max(0, w.requests - 1) // n_pool} "
        f"times; collections by generation {w.collections}; certified "
        f"tier {run.counters}; checked {values['bad_answers']} bad of "
        f"{sum(len(x[3]) for x in w.taken)} answers in {check_s!r} s",
        *w.errors,
    ]
    if w.trace is not None:
        lines.append(
            f"trace: {w.trace.device_events} device operations, "
            f"port kernels {w.trace.port_kernel_s!r} s, least "
            f"{w.trace.least_s}, device {w.trace.kernel_s}, outside the "
            f"wrapped entries {w.trace.unattributed_s!r} s "
            f"{w.trace.unattributed}")
        if w.trace.unattributed_share() > UNATTRIBUTED_MAX:
            lines.append(
                f"bench_gpu: {100 * w.trace.unattributed_share():.2f}% of "
                f"the port kernels' device time ran outside the entries "
                f"that bounds/ names, above {100 * UNATTRIBUTED_MAX}%: the "
                f"rooflines would read part of their launches; no result")
            result = None
    lines += [f"check {name}: {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return result, lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("bench_gpu: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_gpu: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda",
                             t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"bench_gpu: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
