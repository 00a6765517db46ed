"""Drive redis_hnsw_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. It builds the CUDA kernels from
``redis_hnsw_tpu_torch/csrc`` into ``build/``, then:

0. prints the card's name and power limit and the kernels' build time;
1. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged edges: bitwise on integer-lattice
   data (every score exact in f32), to a stated tolerance on Gaussian
   data; times kernel, plain version and a library yardstick;
2. ``hnsw-main``: the reference workload -- an HNSW index of 10,000 x 128
   rows (M=16, efcon=200, native host core) served by ``search_batch``
   on the exact scan tier (kernel A), before and after 100 deletes,
   checked against a float64 brute-force oracle;
3. ``flat-sift1m``: a flat index of 1,000,000 x 128 rows (the SIFT1M
   shape) served 16,384 queries on the certified-exact tier (kernels A
   and B), checked byte-identical to the exact tier on every query and
   against the oracle on a sample.

Every failed check raises, so the script exits non-zero. The last lines
are the card line, one JSON object of per-kernel numbers, and
``{"ok": true, "device": {...}}``. Data come from fixed seeds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# audit every 8th certified batch, so phase 3's eight batches hold one
# audit (ops/scan.py reads this at import)
os.environ["REDIS_HNSW_TPU_SCAN_CERT_AUDIT"] = "8"

import torch  # noqa: E402

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SEED = 7


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(*args) -> None:
    print(*args, flush=True)


def sync_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up, timed
    with CUDA events."""
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- phase 1: kernels against their plain versions -------------------------

def make_case(rng, B, N, D, lattice, dead_frac, dev, live_rows=None):
    if lattice:
        q = rng.integers(-4, 5, (B, D)).astype(np.float32)
        x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    else:
        q = rng.standard_normal((B, D)).astype(np.float32)
        x = rng.standard_normal((N, D)).astype(np.float32)
    live = rng.random(N) >= dead_frac
    if live_rows is not None:
        live[:] = False
        live[rng.choice(N, live_rows, replace=False)] = True
    from redis_hnsw_tpu_torch.ops import distance as Dm
    from redis_hnsw_tpu_torch.ops.cuda_scan import euclid_sq_masked

    qt = torch.from_numpy(q).to(dev)
    xt = torch.from_numpy(x).to(dev)
    sq = torch.from_numpy(np.einsum("nd,nd->n", x, x).astype(np.float32))
    sqm = euclid_sq_masked(sq.to(dev), torch.from_numpy(live).to(dev))
    return qt, xt, sqm, Dm.sqnorms(qt)


def compare_topk(case, k, lattice, label):
    """Kernel A vs its plain version on one case; returns the max abs
    difference of the per-slot sims (matmul form)."""
    from redis_hnsw_tpu_torch.ops import cuda_scan
    from redis_hnsw_tpu_torch.ops import distance as Dm

    qt, xt, sqm, qq = case
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=k)
    pids, psims = cuda_scan.plain_flat_topk(qt, xt, sqm, qq, k=k)
    torch.cuda.synchronize()
    fin = torch.isfinite(psims)
    check(torch.equal(fin, torch.isfinite(sims)),
          f"{label}: kernel A fills other slots than the plain version")
    err = (sims - psims)[fin].abs().max().item() if fin.any() else 0.0
    if lattice:
        check(torch.equal(ids, pids), f"{label}: kernel A ids differ")
        check(torch.equal(sims.view(torch.int32), psims.view(torch.int32)),
              f"{label}: kernel A sims differ bitwise")
        return err
    # Gaussian: direct-form rescored sims agree per slot to 1e-5
    # relative; ids agree wherever the plain version's neighbouring
    # scores differ by more than 1e-4 relative
    mask = ids >= 0
    rs = Dm.exact_neg_sq_l2(qt, xt, ids.clamp(min=0).long(), mask)
    prs = Dm.exact_neg_sq_l2(qt, xt, pids.clamp(min=0).long(), pids >= 0)
    rel = ((rs - prs).abs() / prs.abs().clamp(min=1.0))[fin]
    worst = rel.max().item() if rel.numel() else 0.0
    check(worst <= 1e-5, f"{label}: rescored sims differ by {worst:.3g} rel")
    gap = (psims[:, 1:] - psims[:, :-1]).abs() / psims[:, 1:].abs().clamp(
        min=1.0)
    sep = torch.ones_like(pids, dtype=torch.bool)
    sep[:, 1:] &= gap > 1e-4
    sep[:, :-1] &= gap > 1e-4
    check(torch.equal(ids[sep & fin], pids[sep & fin]),
          f"{label}: kernel A ids differ on well-separated slots")
    return err


def compare_count(case, k_sel, k, lattice, label):
    """Kernel B vs its plain version (lattice: bitwise), and kernel B
    against kernel A's selection: with t = the k-th selected score, the
    counts must equal the selected counts on every query (the
    certificate's soundness). Returns the max abs count difference."""
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan

    qt, xt, sqm, qq = case
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=k_sel)
    sims = sims[:, :k]
    t = sims[:, -1].contiguous()
    c_gt, c_eq = cuda_count.count_gt_eq(xt, sqm, qt, qq, t)
    p_gt, p_eq = cuda_count.plain_count_gt_eq(xt, sqm, qt, qq, t)
    torch.cuda.synchronize()
    err = max((c_gt - p_gt).abs().max().item(),
              (c_eq - p_eq).abs().max().item())
    if lattice:
        check(err == 0, f"{label}: kernel B counts differ from plain")
    s_gt = (sims > t[:, None]).sum(1, dtype=torch.int32)
    s_eq = (sims == t[:, None]).sum(1, dtype=torch.int32)
    fin = torch.isfinite(t)
    check(torch.equal(c_gt, s_gt),
          f"{label}: kernel B > count disagrees with kernel A's selection")
    if not lattice:
        # Gaussian data have no exact ties: every query certifies
        check(torch.equal(c_eq[fin], s_eq[fin]),
              f"{label}: kernel B == count disagrees with kernel A")
    return err


def phase_kernels(dev):
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan

    rng = np.random.default_rng(SEED)
    err_a = err_b = 0.0
    ragged = [
        ("ragged N=1000 B=3 dead", dict(B=3, N=1000, D=128, dead_frac=0.3)),
        ("few live rows", dict(B=5, N=1000, D=128, dead_frac=0, live_rows=6)),
        ("hnsw-main shape", dict(B=2048, N=16384, D=128, dead_frac=0.01)),
        ("flat-sift1m shape", dict(B=2048, N=1_000_064, D=128,
                                   dead_frac=0.0001)),
    ]
    for label, kw in ragged:
        for lattice in (True, False):
            case = make_case(rng, lattice=lattice, dev=dev, **kw)
            tag = f"{label} {'lattice' if lattice else 'gaussian'}"
            for k in (10, 40):
                err_a = max(err_a, compare_topk(case, k, lattice,
                                                f"{tag} k={k}"))
            err_b = max(err_b, compare_count(case, 40, 10, lattice, tag))
            log(f"phase 1: {tag}: kernels A (k=10, k_sel=40) and B agree")
            del case
    torch.cuda.empty_cache()

    # timings at the main path's shape: the certified tier's call at 1M
    B, N, D, k_sel = 2048, 1_000_064, 128, 40
    qt, xt, sqm, qq = make_case(rng, B, N, D, False, 0.0, dev)
    ids, sims = cuda_scan.flat_topk(qt, xt, sqm, qq, k=k_sel)
    t = sims[:, 9].contiguous()
    times = {
        "a_ms": sync_ms(lambda: cuda_scan.flat_topk(qt, xt, sqm, qq,
                                                    k=k_sel), 5),
        "a10_ms": sync_ms(lambda: cuda_scan.flat_topk(qt, xt, sqm, qq,
                                                      k=10), 5),
        "a_plain_ms": sync_ms(lambda: cuda_scan.plain_flat_topk(
            qt, xt, sqm, qq, k=k_sel), 2),
        "lib_ms": sync_ms(lambda: torch.topk(torch.mm(qt, xt.t()), k_sel,
                                             dim=1), 3),
        "b_ms": sync_ms(lambda: cuda_count.count_gt_eq(xt, sqm, qt, qq, t),
                        5),
        "b_plain_ms": sync_ms(lambda: cuda_count.plain_count_gt_eq(
            xt, sqm, qt, qq, t), 2),
    }
    log(f"phase 1: times at B={B} N={N} D={D} (ms): "
        + json.dumps(times))
    shape = {"B": B, "N": N, "D": D}
    flops = 2.0 * B * N * D
    in_bytes = 4.0 * (B * D + N * D + N + B)
    a_bound, a_by = bound_ms(flops, in_bytes + 8.0 * B * k_sel)
    b_bound, b_by = bound_ms(flops, in_bytes + 4.0 * B + 8.0 * B)
    del qt, xt, sqm, qq, ids, sims, t
    torch.cuda.empty_cache()
    return {
        "scan_topk": dict(
            route="cuda", source="redis_hnsw_tpu_torch/csrc/scan_topk.cu",
            replaces="redis_hnsw_tpu/ops/pallas_scan.py:165",
            max_abs_err=err_a, ms=times["a_ms"], plain_ms=times["a_plain_ms"],
            bound_ms=a_bound, bound_by=a_by, library_ms=times["lib_ms"],
            shape=dict(shape, k=k_sel),
        ),
        "count_gt_eq": dict(
            route="cuda", source="redis_hnsw_tpu_torch/csrc/count_gt_eq.cu",
            replaces="redis_hnsw_tpu/ops/pallas_count.py:78",
            max_abs_err=err_b, ms=times["b_ms"], plain_ms=times["b_plain_ms"],
            bound_ms=b_bound, bound_by=b_by, library_ms=None,
            shape=shape,
        ),
    }


# -- phases 2 and 3: the main path ----------------------------------------

def oracle_check(xs64, live, qs, names_of_row, names, sims, k, label):
    """Replies against a float64 brute force over the live rows: each
    reply holds k distinct live names, nearest first, whose distances
    are within the k-th oracle distance (ties allowed) and whose sims
    match the float64 distances to 1e-5 relative."""
    q64 = torch.as_tensor(qs, dtype=torch.float64, device=xs64.device)
    d = ((q64 * q64).sum(1)[:, None] + (xs64 * xs64).sum(1)[None, :]
         - 2.0 * q64 @ xs64.t())
    d[:, torch.from_numpy(~live).to(xs64.device)] = float("inf")
    kth = torch.topk(d, k, dim=1, largest=False).values[:, -1].cpu().numpy()
    d = d.cpu().numpy()
    row_of = {n: i for i, n in enumerate(names_of_row)}
    for b in range(len(qs)):
        rows = [row_of.get(n, -1) for n in names[b]]
        check(len(set(rows)) == k and min(rows) >= 0,
              f"{label}: query {b} reply is not {k} distinct live names")
        check(all(live[r] for r in rows),
              f"{label}: query {b} returned a deleted row")
        dist = d[b, rows]
        tol = 1e-5 * max(1.0, abs(kth[b]))
        check((dist <= kth[b] + tol).all(),
              f"{label}: query {b} missed a nearer row")
        check(np.allclose(-dist, sims[b], rtol=1e-5, atol=1e-5),
              f"{label}: query {b} sims off the oracle")
        check((np.diff(sims[b]) <= 0).all(),
              f"{label}: query {b} not nearest first")


def reset_counts():
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan

    cuda_scan.flat_topk.launches = 0
    cuda_count.count_gt_eq.launches = 0


def read_counts():
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan

    return {"scan_topk": cuda_scan.flat_topk.launches,
            "count_gt_eq": cuda_count.count_gt_eq.launches}


def phase_hnsw(client, dev):
    n, dim, n_q, k = 10_000, 128, 2048, 10
    rng = np.random.default_rng(SEED)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((n_q, dim)).astype(np.float32)
    names = [f"v{i}" for i in range(n)]
    reset_counts()
    client.create_index("hnsw-main", dim=dim, m=16, ef_construction=200,
                        seed=SEED, backend="native")
    t0 = time.perf_counter()
    for i in range(n):
        client.add_node("hnsw-main", names[i], data[i])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cnames, csims = client.search_batch("hnsw-main", qs, k=k,
                                        reply="columnar")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cnames, csims = client.search_batch("hnsw-main", qs, k=k,
                                        reply="columnar")
    col_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    objs = client.search_batch("hnsw-main", qs, k=k)
    obj_s = time.perf_counter() - t0
    check([[r.name for r in row] for row in objs] == cnames.tolist(),
          "hnsw-main: object and columnar replies differ")
    victims = rng.choice(n, 100, replace=False)
    for v in victims:
        client.delete_node("hnsw-main", names[v])
    dnames, dsims = client.search_batch("hnsw-main", qs, k=k,
                                        reply="columnar")
    counts = read_counts()
    check(counts["scan_topk"] > 0, "hnsw-main: kernel A never launched")
    dead = {names[v] for v in victims}
    check(not dead & set(dnames.ravel().tolist()),
          "hnsw-main: a deleted name was served")
    xs64 = torch.from_numpy(data).to(dev, torch.float64)
    live = np.ones(n, bool)
    oracle_check(xs64, live, qs, names, cnames, csims, k, "hnsw-main")
    live[victims] = False
    oracle_check(xs64, live, qs, names, dnames, dsims, k,
                 "hnsw-main after deletes")
    log(f"phase 2: hnsw-main: built {n} rows by add_node in {build_s:.2f} s "
        f"({n / build_s:.0f} inserts/s); search_batch {n_q} queries k={k}: "
        f"first call {first_s * 1e3:.1f} ms (snapshot + kernel load), "
        f"columnar {n_q / col_s:.0f} qps, objects {n_q / obj_s:.0f} qps; "
        f"launches {counts}; replies match the float64 oracle before and "
        f"after 100 deletes")
    client.delete_index("hnsw-main")
    return counts


def phase_flat(client, dev):
    from redis_hnsw_tpu_torch.ops import scan as S

    n, dim, n_q, k = 1_000_000, 128, 16_384, 10
    rng = np.random.default_rng(SEED + 1)
    data = rng.standard_normal((n, dim), dtype=np.float32)
    qs = rng.standard_normal((n_q, dim), dtype=np.float32)
    names = [f"s{i}" for i in range(n)]
    torch.cuda.reset_peak_memory_stats()
    idx = client.create_index("flat-sift1m", dim=dim, kind="flat")
    t0 = time.perf_counter()
    client.add_batch("flat-sift1m", names, data)
    add_s = time.perf_counter() - t0
    check(S.cert_enabled(1_000_064, dim), "flat-sift1m: certified tier off")
    before = dict(S.CERT_STATS)
    reset_counts()
    t0 = time.perf_counter()
    cnames, csims = idx.search_batch(qs, k, reply="columnar")
    first_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["scan_topk"] > 0 and counts["count_gt_eq"] > 0,
          f"flat-sift1m: a kernel never launched: {counts}")
    t0 = time.perf_counter()
    cnames2, csims2 = idx.search_batch(qs, k, reply="columnar")
    cert_s = time.perf_counter() - t0
    check(np.array_equal(cnames, cnames2)
          and np.array_equal(csims.view(np.int32), csims2.view(np.int32)),
          "flat-sift1m: two certified runs differ")
    stats = {key: S.CERT_STATS.get(key, 0) - before.get(key, 0)
             for key in ("batches", "queries", "fallback_queries",
                         "audits", "audit_mismatches")}
    share = 1.0 - stats["fallback_queries"] / stats["queries"]
    check(share >= 0.99, f"flat-sift1m: certified share {share}")
    check(stats["audits"] >= 1 and stats["audit_mismatches"] == 0,
          f"flat-sift1m: audit {stats}")
    os.environ["REDIS_HNSW_TPU_SCAN_CERT"] = "0"
    try:
        t0 = time.perf_counter()
        enames, esims = idx.search_batch(qs, k, reply="columnar")
        exact_s = time.perf_counter() - t0
    finally:
        del os.environ["REDIS_HNSW_TPU_SCAN_CERT"]
    check(np.array_equal(cnames, enames)
          and np.array_equal(csims.view(np.int32), esims.view(np.int32)),
          "flat-sift1m: certified replies differ from the exact tier")
    objs = client.search_batch("flat-sift1m", qs[:8], k=k)
    check([[r.name for r in row] for row in objs] == cnames[:8].tolist(),
          "flat-sift1m: client object replies differ")
    xs64 = torch.from_numpy(data).to(dev, torch.float64)
    live = np.ones(n, bool)
    oracle_check(xs64, live, qs[:64], names, cnames, csims, k,
                 "flat-sift1m")
    del xs64
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 3: flat-sift1m: add_batch {n} rows {add_s:.2f} s; "
        f"search_batch {n_q} queries k={k} certified: first call "
        f"{first_s:.3f} s (table upload), then {n_q / cert_s:.0f} qps; "
        f"exact tier {n_q / exact_s:.0f} qps; certified share {share:.6f}, "
        f"cert stats {stats}; byte-identical to the exact tier on all "
        f"{n_q} queries; launches {counts}; max_memory_allocated "
        f"{peak} bytes")
    client.delete_index("flat-sift1m")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    import redis_hnsw_tpu_torch as h
    from redis_hnsw_tpu_torch.utils import build

    t0 = time.perf_counter()
    paths = build.build_kernels()
    log(f"phase 0: built {sorted(paths)} in {time.perf_counter() - t0:.2f} s")
    for path in paths.values():
        for line in build.build_log(path).splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    dev = torch.device("cuda")

    kernels = phase_kernels(dev)
    client = h.HNSW()
    launches = phase_hnsw(client, dev)
    for name, c in phase_flat(client, dev).items():
        launches[name] += c
    log(card)
    log(json.dumps({"kernels": [
        dict(name=name, launches=launches[name], **row)
        for name, row in kernels.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
