"""Drive redis_hnsw_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. It builds the CUDA kernels from
``redis_hnsw_tpu_torch/csrc`` into ``build/``, then:

0. prints the card's name and power limit, the kernels' build time and,
   for kernels A, A′, B and D (the split kernels) and C, ptxas registers,
   spills, shared memory and resident blocks (C's at its main plans);
1. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged edges: bitwise on integer-lattice
   data (every score exact in f32) and on random hamming words, to a
   stated tolerance on Gaussian data; times kernel, plain version and a
   library yardstick. Kernel A (exact scan top-k) is also held bitwise
   at its 128 x 128 tile's and its splits' edges, with equal rows planted
   across them, at k = 1 ... 1000 and in its 4-byte-copy form, and timed
   with the SM clock sampled, at B = 16 over 1,000,064 rows and at
   hnsw-main's 2048 x 16,384. Kernel B (threshold counts) is held
   bitwise in the same kinds of edge cases, with tie classes planted at
   t, at D = 1/33/129, in its 4-byte-copy form and at t = -inf, and timed
   at the same three shapes with the SM clock sampled, beside a
   three-call yardstick (torch.mm, then the two compare-sums), and its
   counts at the flat-sift1m shape must equal kernel A's selection on
   every query. Kernel C (block gather-score) is held bitwise at F =
   1/31/32/33/256, D = 1/24/33/129, B = 1, E = 1/300, with a candidate
   repeated within a lane and in its general form (operands 4 bytes off
   a 16-byte boundary), a Gaussian row planted at several (e, f) of
   several blocks must score the same bits in every copy and form
   (block, row, general, _entry_sims' narrowed rows), and it is timed
   with the SM clock sampled over a SIFT1M-size block table (1,000,064
   rows x 32 neighbours x 128 dims; f32, f16, bf16; B = 2048 and 16) and
   in its row form over those rows (J = 512 and 16), beside its byte
   bound and a library yardstick (the block gather, torch.bmm and the
   sqnorm gather); kernel A′ (exact hamming top-k) is held bitwise in the
   same kinds of edge cases, with tie classes planted, at k = 1 ... 1000
   and W = 1 ... 32 in both copy forms, and timed over 1,000,064 x
   256-bit rows (k_sel = 40 and k = 10, with the SM clock sampled), at
   B = 16 over those rows and at 2048 x 16,384; kernel D
   (one-pass bin select) at its 128 x 128 tile's edges (B, N at
   127/128/129, D = 1/33/129, split boundaries, a dead bin, a duplicate
   row) and at the flat-sift1m shape, where its best candidate per query
   must be kernel A's top-1 and its stable top-10 on every query it
   certifies kernel A's top-10, bit for bit;
2. ``hnsw-main``: the reference workload -- an HNSW index of 10,000 x 128
   rows (M=16, efcon=200, native host core) built by
   ``add_batch(batch_size=2048)`` as bench.py builds it (layer-0
   candidates from kernel A, upper beams on kernel C's row form; its
   phase breakdown and snapshot refreshes logged; the same rows by
   ``add_node`` timed beside it) and served by ``search_batch`` on the
   exact scan tier (kernel A) and on the graph engine (kernel C; the (ef,
   iters) sweep of bench.py up to recall@10 >= 0.95), before and after
   100 deletes, and on the f16 and row-gather frontier tiers, checked
   against a float64 brute-force oracle;
2b. ``graph-lattice``: a 2,000-row integer-lattice HNSW index whose
   graph-engine replies on the card must equal the CPU's byte for byte;
   then the same rows bulk-built on the card and on the CPU (512-row
   waves, the last partial; ``REDIS_HNSW_TPU_BUILD_L0`` scan and beam)
   must give the same graph byte for byte;
2c. ``hnsw-hamming-256b``: bench.py's config5 -- 10,000 x 256 random
   bits, M=16, efcon=200, built by ``add_batch(batch_size=2048)`` -- served
   by the exact scan (kernel A′), equal to a numpy brute force byte for
   byte, and by the graph engine over config5's sweep up to tie-aware
   recall@10 >= 0.95; then a 2,000-row hamming index whose card replies
   must equal the CPU's byte for byte;
2d. ``hnsw-build-sift1m-shape``: ``add_batch(batch_size=2048)`` of 262,144
   x 128 seeded Gaussian rows (SIFT1M's width, a quarter of its rows),
   M=16, efcon=200: inserts/s, the phase breakdown, one full snapshot
   build and deltas after it, kernel A timed at the build's shape (k =
   64); then 2048 queries on the exact tier and on the graph engine
   against a float64 oracle computed on the card. ``python3
   chip_smoke.py --build-rows 1000000`` runs this phase alone at SIFT1M's
   size;
3. ``flat-sift1m``: a flat index of 1,000,000 x 128 rows (the SIFT1M
   shape) served 16,384 queries on the certified-exact tier's two-pass
   form (REDIS_HNSW_TPU_CERT_ONEPASS=0, kernels A and B), checked
   byte-identical to the exact tier on every query and against the
   oracle on a sample, with kernel B's share of the batch time;
3c. the same index on the certified tier's default, one-pass form
   (kernel D): byte-identical to the exact tier on every query,
   certified share >= 0.95, and kernel D's share of the batch time;
3b. ``flat-hamming-sift256``: a flat index of 1,000,000 x 256-bit rows
   (the shape of ann-benchmarks' sift-256-hamming, seeded random bits)
   served 16,384 queries on the exact hamming tier (kernel A′), which a
   hamming table takes at every size, byte-identical to use_pallas=True
   on every query and to a numpy brute force on a sample.

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
PEAK_F16_FLOPS = 989e12   # H100 SXM, fp16 tensor cores, dense
PEAK_INT8_OPS = 1979e12   # H100 SXM, int8 tensor cores, dense
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Population counts per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table); times the
# SM count and the card's maximum SM clock, read from the card.
POPC_PER_CLOCK_SM = 16
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


def graph_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches captured in one
    CUDA graph, for kernels shorter than their launch's host cost."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return sync_ms(graph.replay, 5) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


class ClockSampler:
    """The card's SM clock (MHz) and power draw (W), sampled by nvidia-smi
    every 50 ms while the ``with`` block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                pass
        self.mhz = sorted(r[0] for r in rows)
        self.watts = max((r[1] for r in rows), default=float("nan"))
        return False

    def summary(self) -> str:
        if not self.mhz:
            return "no clock samples"
        return (f"SM clock median {self.mhz[len(self.mhz) // 2]:.0f} MHz, min "
                f"{self.mhz[0]:.0f} ({len(self.mhz)} samples), power up to "
                f"{self.watts:.0f} W")


def timed(fn, reps: int):
    """(host seconds per call, last result) over ``reps`` calls after
    one warm-up; each call ends in a host copy, so the clock covers the
    device work."""
    out = fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def popc_peak(dev) -> float:
    """The card's population-count rate, per second."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return POPC_PER_CLOCK_SM * sms * max_sm_clock_hz()


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


def compare_topk(case, k, lattice, label, planted=None):
    """Kernel A vs its plain version on one case; returns the max abs
    difference of the per-slot sims (matmul form). ``planted``: the row
    at whose sides :func:`plant_equal_rows` put query 0's copies."""
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
        if planted is not None:
            want = [planted - 1, planted, planted + 1][:k]
            check(ids[0, :3].tolist() == want,
                  f"{label}: kernel A misorders equal rows at {planted}")
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
        ("one-pass fallback shape", dict(B=16, N=1_000_064, D=128,
                                         dead_frac=0.0001)),
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
    with ClockSampler() as clock:
        a_ms = sync_ms(lambda: cuda_scan.flat_topk(qt, xt, sqm, qq,
                                                   k=k_sel), 20)
    with ClockSampler() as b_clock:
        b_ms = sync_ms(lambda: cuda_count.count_gt_eq(xt, sqm, qt, qq, t),
                       20)
    q16, qq16 = qt[:16].contiguous(), qq[:16].contiguous()
    t16 = t[:16].contiguous()
    times = {
        "a_ms": a_ms,
        "a10_ms": sync_ms(lambda: cuda_scan.flat_topk(qt, xt, sqm, qq,
                                                      k=10), 20),
        # the one-pass fallback's batch, and hnsw-main's scan
        "a_b16_ms": sync_ms(lambda: cuda_scan.flat_topk(q16, xt, sqm, qq16,
                                                        k=10), 20),
        "a_hnsw_ms": sync_ms(lambda: cuda_scan.flat_topk(
            qt, xt[:16_384], sqm[:16_384], qq, k=10), 20),
        "a_plain_ms": sync_ms(lambda: cuda_scan.plain_flat_topk(
            qt, xt, sqm, qq, k=k_sel), 2),
        "lib_ms": sync_ms(lambda: torch.topk(torch.mm(qt, xt.t()), k_sel,
                                             dim=1), 3),
        "b_ms": b_ms,
        "b_b16_ms": sync_ms(lambda: cuda_count.count_gt_eq(
            xt, sqm, q16, qq16, t16), 20),
        "b_hnsw_ms": sync_ms(lambda: cuda_count.count_gt_eq(
            xt[:16_384], sqm[:16_384], qt, qq, t), 20),
        "b_plain_ms": sync_ms(lambda: cuda_count.plain_count_gt_eq(
            xt, sqm, qt, qq, t), 2),
        # B's yardstick, three calls: the product, then the two counts
        "b_lib_ms": sync_ms(lambda: count_yardstick(qt, xt, t), 3),
    }
    shapes = (("B=2048", (B, N)), ("B=16", (16, N)),
              ("2048x16384", (B, 16_384)))
    splits = {shape: cuda_scan.plan(dev, b, n) for shape, (b, n) in shapes}
    b_splits = {shape: cuda_count.plan(dev, b, n) for shape, (b, n) in shapes}
    log(f"phase 1: times at B={B} N={N} D={D} (ms; (splits, tiles per "
        f"split) of kernel A {splits}, of kernel B {b_splits}; while A ran "
        f"at k={k_sel}: {clock.summary()}; while B ran: "
        f"{b_clock.summary()}): " + json.dumps(times))
    shape = {"B": B, "N": N, "D": D}
    flops = 2.0 * B * N * D
    in_bytes = 4.0 * (B * D + N * D + N + B)
    a_bound, a_by = bound_ms(flops, in_bytes + 8.0 * B * k_sel)
    b_bound, b_by = bound_ms(flops, in_bytes + 4.0 * B + 8.0 * B)
    del qt, xt, sqm, qq, ids, sims, t, q16, qq16, t16
    torch.cuda.empty_cache()
    err_a = max(err_a, phase_scan_edges(dev))
    err_b = max(err_b, phase_count_edges(dev))
    return {
        "scan_topk": dict(
            route="cuda", source="redis_hnsw_tpu_torch/csrc/scan_topk.cu",
            replaces="redis_hnsw_tpu/ops/pallas_scan.py:165",
            max_abs_err=err_a, ms=times["a_ms"], plain_ms=times["a_plain_ms"],
            bound_ms=a_bound, bound_by=a_by, library_ms=times["lib_ms"],
            ms_k10=times["a10_ms"], ms_b16=times["a_b16_ms"],
            ms_hnsw=times["a_hnsw_ms"], shape=dict(shape, k=k_sel),
        ),
        "count_gt_eq": dict(
            route="cuda", source="redis_hnsw_tpu_torch/csrc/count_gt_eq.cu",
            replaces="redis_hnsw_tpu/ops/pallas_count.py:78",
            max_abs_err=err_b, ms=times["b_ms"], plain_ms=times["b_plain_ms"],
            bound_ms=b_bound, bound_by=b_by, library_ms=times["b_lib_ms"],
            library_calls="torch.mm, then (s > t).sum and (s == t).sum",
            ms_b16=times["b_b16_ms"], ms_hnsw=times["b_hnsw_ms"],
            shape=shape,
        ),
    }


def plant_equal_rows(case, edge):
    """Query 0's copy at rows edge - 1, edge and edge + 1, all live: its
    top 3 must be those rows in id order."""
    qt, xt, sqm, _ = case
    xt[edge - 1 : edge + 2] = qt[0]
    sqm[edge - 1 : edge + 2] = (qt[0] * qt[0]).sum()


def phase_scan_edges(dev):
    """Kernel A bitwise against its plain version on lattice data: at the
    edges of its 128 x 128 tile (B, N at 1/127/128/129, B = 2049) and of
    its splits (N one row short of, at and past a boundary), with dead
    rows and equal rows planted across the tile edge and the boundary; at
    every width (k = 1 ... 1000), also with fewer
    live rows than k; and in its 4-byte-copy form (D = 33, and operands
    4 bytes off a 16-byte boundary). Returns the max abs difference."""
    from redis_hnsw_tpu_torch.ops import cuda_scan

    rng = np.random.default_rng(SEED + 9)
    err, cases = 0.0, 0
    for B in (1, 127, 128, 129, 2049):
        for N in (1, 127, 128, 129, "split-1", "split+0", "split+1"):
            edge = 128
            if isinstance(N, str):
                N, edge = split_edge(cuda_scan.plan, dev, B,
                                     int(N[len("split"):]))
            case = make_case(rng, B, N, 128, True, 0.1, dev)
            planted = edge if N > edge + 1 else None
            if planted:
                plant_equal_rows(case, edge)
            err = max(err, compare_topk(case, 10, True,
                                        f"A edge B={B} N={N}", planted))
            cases += 1
    for k in (1, 10, 40, 64, 256, 300, 1000):
        for live_rows in (None, 7):
            case = make_case(rng, 130, 5000, 128, True, 0.2, dev,
                             live_rows=live_rows)
            plant_equal_rows(case, 128)
            err = max(err, compare_topk(
                case, k, True, f"A k={k} live_rows={live_rows}",
                None if live_rows else 128))
            cases += 1
    for D, off in ((33, 0), (128, 1)):
        qt, xt, sqm, qq = make_case(rng, 130, 3000, D, True, 0.1, dev)
        q_off = torch.empty(qt.numel() + off, device=dev)[off:].view_as(qt)
        x_off = torch.empty(xt.numel() + off, device=dev)[off:].view_as(xt)
        q_off.copy_(qt)
        x_off.copy_(xt)
        case = (q_off, x_off, sqm, qq)
        plant_equal_rows(case, 128)
        err = max(err, compare_topk(case, 40, True,
                                    f"A 4-byte form D={D} offset={off}", 128))
        cases += 1
    log(f"phase 1: kernel A bitwise equal to its plain version in {cases} "
        f"edge cases (tile and split edges, planted equal rows, k = 1 ... "
        f"1000, few live rows, the 4-byte form)")
    return err


def count_yardstick(qt, xt, t):
    """Kernel B's library yardstick: ``torch.mm`` of the queries and rows,
    then the two compare-sums against ``t`` (three calls; the port never
    calls them)."""
    s = torch.mm(qt, xt.t())
    return (s > t[:, None]).sum(1), (s == t[:, None]).sum(1)


def plant_tie_class(case, edge):
    """Row edge - 2 copied to rows edge - 1 .. edge + 1, all live: a tie
    class of 4 rows across the edge for every query."""
    _, xt, sqm, _ = case
    xt[edge - 1 : edge + 2] = xt[edge - 2]
    sqm[edge - 2 : edge + 2] = (xt[edge - 2] * xt[edge - 2]).sum()


def count_thresholds(rng, case, edge=None):
    """Per query a real score of a random live row (or, for every other
    query, of the tie class planted at ``edge``), and -inf on every 7th
    query."""
    from redis_hnsw_tpu_torch.ops import distance as Dm

    qt, xt, sqm, qq = case
    scores = Dm.pairwise_neg_sq_l2(qt, xt, sqm, qq)
    live = torch.isfinite(sqm).nonzero()[:, 0]
    if not len(live):  # a one-row table whose row is dead
        live = torch.zeros(1, dtype=torch.int64, device=qt.device)
    B = qt.shape[0]
    pick = live[torch.from_numpy(rng.integers(0, len(live), B)).to(live)]
    if edge is not None:
        pick[::2] = edge - 2
    t = scores[torch.arange(B, device=qt.device), pick]
    t[3::7] = float("-inf")
    return t.contiguous()


def count_bitwise(case, t, label):
    """Kernel B's counts equal its plain version's; returns them."""
    from redis_hnsw_tpu_torch.ops import cuda_count

    qt, xt, sqm, qq = case
    got = cuda_count.count_gt_eq(xt, sqm, qt, qq, t)
    want = cuda_count.plain_count_gt_eq(xt, sqm, qt, qq, t)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label}: kernel B counts differ from its plain version")
    return got


def phase_count_edges(dev):
    """Kernel B bitwise against its plain version on lattice data: at the
    edges of its 128 x 128 tile (B, N at 1/127/128/129, B = 2049) and of
    its splits (N one row short of, at and past a boundary), with dead
    rows and a tie class at t planted across the tile edge and the
    boundary; at D = 1, 33 and 129 and in its 4-byte-copy form (D = 33,
    and operands 4 bytes off a 16-byte boundary); at t = -inf with dead
    rows and a ragged last tile (every live row counts as >, every dead
    row as ==, the padding never); and at B = 16 over 400,003 rows.
    Returns the max abs count difference (0)."""
    from redis_hnsw_tpu_torch.ops import cuda_count

    rng = np.random.default_rng(SEED + 11)
    cases = 0
    for B in (1, 127, 128, 129, 2049):
        for N in (1, 127, 128, 129, "split-1", "split+0", "split+1"):
            edge = 128
            if isinstance(N, str):
                N, edge = split_edge(cuda_count.plan, dev, B,
                                     int(N[len("split"):]))
            case = make_case(rng, B, N, 128, True, 0.1, dev)
            planted = N > edge + 1
            if planted:
                plant_tie_class(case, edge)
            t = count_thresholds(rng, case, edge if planted else None)
            _, c_eq = count_bitwise(case, t, f"B edge B={B} N={N}")
            fin = torch.isfinite(t[::2])
            check(not planted or (c_eq[::2][fin] >= 4).all().item(),
                  f"B edge B={B} N={N}: the planted tie class not counted")
            cases += 1
    for D, off in ((1, 0), (33, 0), (129, 0), (33, 1), (128, 1)):
        qt, xt, sqm, qq = make_case(rng, 130, 3000, D, True, 0.1, dev)
        q_off = torch.empty(qt.numel() + off, device=dev)[off:].view_as(qt)
        x_off = torch.empty(xt.numel() + off, device=dev)[off:].view_as(xt)
        q_off.copy_(qt)
        x_off.copy_(xt)
        case = (q_off, x_off, sqm, qq)
        plant_tie_class(case, 128)
        count_bitwise(case, count_thresholds(rng, case, 128),
                      f"B D={D} offset={off}")
        cases += 1
    for N in (1000, split_edge(cuda_count.plan, dev, 130, 1)[0]):
        case = make_case(rng, 130, N, 128, True, 0.3, dev)
        t = torch.full((130,), float("-inf"), device=dev)
        c_gt, c_eq = count_bitwise(case, t, f"B t=-inf N={N}")
        live = int(torch.isfinite(case[2]).sum())
        check((c_gt == live).all().item() and (c_eq == N - live).all().item(),
              f"B t=-inf N={N}: counts {c_gt[0]}, {c_eq[0]} of {live} live "
              f"rows")
        cases += 1
    case = make_case(rng, 16, 400_003, 128, True, 0.1, dev)
    plant_tie_class(case, 200_000)
    count_bitwise(case, count_thresholds(rng, case, 200_000),
                  "B B=16 N=400003")
    cases += 1
    log(f"phase 1: kernel B bitwise equal to its plain version in {cases} "
        f"edge cases (tile and split edges, planted tie classes at t, D = "
        f"1/33/129, the 4-byte form, t = -inf over dead rows and a ragged "
        f"tile, B = 16 over 400,003 rows)")
    return 0.0


def word_case(rng, B, N, W, dead_frac, dev):
    """Kernel A′ operands: random words (high bit included), a
    distance-0 row and a tie class for query 0, ``dead_frac`` dead rows."""
    from redis_hnsw_tpu_torch.ops.cuda_scan import hamming_bias

    q = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    x = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    x[N // 2] = x[N // 3] = q[0]
    live = rng.random(N) >= dead_frac
    live[N // 2] = True
    return (words_on(q, dev), words_on(x, dev),
            hamming_bias(torch.from_numpy(live).to(dev)))


def words_on(a, dev):
    """uint32 words as the port's int32 tensor on ``dev`` (same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


def plant_word_ties(case, edge):
    """Query 0's copy at rows edge - 1 .. edge + 1, live (its top 3, in id
    order), and row edge - 2's copy at rows edge + 2 .. edge + 5 (a tie
    class at every distance across the edge); word_case's copies of query
    0 move to distance 1 first."""
    qt, xt, bias = case
    n = xt.shape[0]
    xt[n // 2, 0] ^= 1
    xt[n // 3, 0] ^= 1
    xt[edge - 1 : edge + 2] = qt[0]
    bias[edge - 1 : edge + 2] = 0.0
    xt[edge + 2 : edge + 6] = xt[edge - 2]


def compare_hamming(case, k, label, planted=None):
    """Kernel A′ against its plain version, bitwise. ``planted``: the row
    at whose sides :func:`plant_word_ties` put query 0's copies. Returns
    the max abs difference."""
    from redis_hnsw_tpu_torch.ops import cuda_scan

    qt, xt, bias = case
    ids, sims = cuda_scan.flat_topk_hamming(qt, xt, bias, k=k)
    pids, psims = cuda_scan.plain_flat_topk_hamming(qt, xt, bias, k=k)
    torch.cuda.synchronize()
    fin = torch.isfinite(psims)
    check(torch.equal(ids, pids), f"{label}: kernel A′ ids differ")
    check(torch.equal(sims.view(torch.int32), psims.view(torch.int32)),
          f"{label}: kernel A′ sims differ bitwise")
    if planted is not None:
        want = [planted - 1, planted, planted + 1][:k]
        check(ids[0, :3].tolist() == want,
              f"{label}: kernel A′ misorders equal rows at {planted}")
    return (sims - psims)[fin].abs().max().item() if fin.any() else 0.0


def hamming_plan(dev, B, N):
    from redis_hnsw_tpu_torch.ops import cuda_scan

    return cuda_scan.plan(dev, B, N, hamming=True)


def phase_hamming_edges(dev):
    """Kernel A′ bitwise against its plain version: at the edges of its
    128 x 128 tile (B, N at 1/127/128/129, B = 2049) and of its splits (N
    one row short of, at and past a boundary), with dead rows and tie
    classes planted across the tile edge and the boundary; at every width
    (k = 1 ... 1000), also with fewer live rows than k; and at W = 1, 3,
    8, 25 and 32, on an aligned table and on one 4 bytes off a 16-byte
    boundary (its 16-byte and 4-byte copy forms). Returns the max abs
    difference."""
    rng = np.random.default_rng(SEED + 10)
    err, cases = 0.0, 0
    for B in (1, 127, 128, 129, 2049):
        for N in (1, 127, 128, 129, "split-1", "split+0", "split+1"):
            edge = 128
            if isinstance(N, str):
                N, edge = split_edge(hamming_plan, dev, B,
                                     int(N[len("split"):]))
            case = word_case(rng, B, N, 8, 0.1, dev)
            planted = edge if N > edge + 5 else None
            if planted:
                plant_word_ties(case, edge)
            err = max(err, compare_hamming(case, 10, f"A′ edge B={B} N={N}",
                                           planted))
            cases += 1
    for k in (1, 10, 40, 64, 256, 257, 300, 1000):
        for live_rows in (None, 7):
            case = word_case(rng, 130, 5000, 3, 0.2, dev)
            if live_rows:
                case[2].fill_(float("-inf"))
                case[2][torch.from_numpy(rng.choice(5000, live_rows,
                                                    replace=False)).to(dev)] = 0
            plant_word_ties(case, 128)
            err = max(err, compare_hamming(
                case, k, f"A′ k={k} live_rows={live_rows}", 128))
            cases += 1
    for W in (1, 3, 8, 25, 32):
        for off in (0, 1):
            qt, xt, bias = word_case(rng, 130, 3000, W, 0.1, dev)
            x_off = torch.empty(xt.numel() + off, dtype=torch.int32,
                                device=dev)[off:].view_as(xt)
            x_off.copy_(xt)
            case = (qt, x_off, bias)
            plant_word_ties(case, 128)
            err = max(err, compare_hamming(
                case, 40, f"A′ W={W} offset={off}", 128))
            cases += 1
    log(f"phase 1: kernel A′ bitwise equal to its plain version in {cases} "
        f"edge cases (tile and split edges, planted tie classes, k = 1 ... "
        f"1000, few live rows, W = 1/3/8/25/32 in both copy forms)")
    return err


def phase_hamming_kernels(dev):
    """Kernel A′: bitwise at ragged shapes, at flat-hamming-sift256's (B =
    2048, 1,000,064 rows of 8 words, k = 10 and k_sel = 40) and in
    :func:`phase_hamming_edges`; timed there with the SM clock sampled,
    also at B = 16 over those rows and at hnsw-hamming-256b's 2048 x
    16,384, beside its int8 tensor-core bound (the popcount bound logged
    beside it) and a tensor-core yardstick (torch.mm of the +-1 tables in
    f16, exact for +-1 values, then torch.topk), which the port never
    calls."""
    from redis_hnsw_tpu_torch.ops import cuda_scan

    rng = np.random.default_rng(SEED + 5)
    err_a = 0.0
    shapes = [
        ("W=1 k=1", dict(B=37, N=100_003, W=1), (1, 256)),
        ("W=3 k=256", dict(B=37, N=100_003, W=3), (256,)),
        ("W=25 k=1/256", dict(B=130, N=20_011, W=25), (1, 256)),
        ("flat-hamming-sift256 shape", dict(B=2048, N=1_000_064, W=8),
         (10, 40)),
    ]
    for label, kw, ks in shapes:
        case = word_case(rng, dead_frac=0.15, dev=dev, **kw)
        for k in ks:
            err_a = max(err_a, compare_hamming(case, k, f"{label} k={k}"))
        log(f"phase 1: {label} {kw}: kernel A′ (k={ks}) agrees bitwise")
        del case
    torch.cuda.empty_cache()
    err_a = max(err_a, phase_hamming_edges(dev))

    B, N, W, k_sel = 2048, 1_000_064, 8, 40
    qt, xt, bias = word_case(rng, B, N, W, 0.0, dev)
    q16 = cuda_scan.pm1_table(qt).half()
    x16 = cuda_scan.pm1_table(xt).half()
    with ClockSampler() as clock:
        a_ms = sync_ms(lambda: cuda_scan.flat_topk_hamming(
            qt, xt, bias, k=k_sel), 20)
    qs16 = qt[:16].contiguous()
    times = {
        "a_ms": a_ms,
        "a10_ms": sync_ms(lambda: cuda_scan.flat_topk_hamming(
            qt, xt, bias, k=10), 20),
        "a_b16_ms": sync_ms(lambda: cuda_scan.flat_topk_hamming(
            qs16, xt, bias, k=10), 20),
        "a_hnsw_ms": sync_ms(lambda: cuda_scan.flat_topk_hamming(
            qt, xt[:16_384], bias[:16_384], k=10), 20),
        "a_plain_ms": sync_ms(lambda: cuda_scan.plain_flat_topk_hamming(
            qt, xt, bias, k=k_sel), 2),
        "lib_ms": sync_ms(lambda: torch.topk(torch.mm(q16, x16.t()), k_sel,
                                             dim=1), 3),
    }
    del q16, x16
    splits = {shape: hamming_plan(dev, b, n) for shape, (b, n) in
              (("B=2048", (B, N)), ("B=16", (16, N)),
               ("2048x16384", (B, 16_384)))}
    log(f"phase 1: hamming times at B={B} N={N} W={W} (ms; kernel A′'s "
        f"(splits, tiles per split) {splits}; while A′ ran at k={k_sel}: "
        f"{clock.summary()}): " + json.dumps(times))
    ops = 2.0 * B * N * 32 * W
    popc = float(B) * N * W
    in_bytes = 4.0 * (B * W + N * W + N) + 8.0 * B * k_sel
    a_bound, a_by = bound_ms(ops, in_bytes, PEAK_INT8_OPS)
    peak = popc_peak(dev)
    popc_bound, _ = bound_ms(popc, in_bytes, peak)
    tc_bound, _ = bound_ms(2.0 * B * N * 32 * W, 2.0 * 32 * W * (B + N),
                           PEAK_F16_FLOPS)
    log(f"phase 1: hamming bounds: {ops:.4g} int8 operations at "
        f"{PEAK_INT8_OPS:.4g}/s -> A′ {a_bound:.4f} ms ({a_by}); as "
        f"{popc:.4g} popcounts at {peak:.4g}/s {popc_bound:.4f} ms; the f16 "
        f"yardstick's own bound {tc_bound:.4f} ms")
    del qt, xt, bias, qs16
    torch.cuda.empty_cache()
    shape = {"B": B, "N": N, "W": W}
    return {
        "scan_topk_hamming": dict(
            route="cuda", source="redis_hnsw_tpu_torch/csrc/scan_topk.cu",
            replaces="redis_hnsw_tpu/ops/pallas_scan.py:122",
            max_abs_err=err_a, ms=times["a_ms"], plain_ms=times["a_plain_ms"],
            bound_ms=a_bound, bound_by=a_by, library_ms=times["lib_ms"],
            ms_k10=times["a10_ms"], ms_b16=times["a_b16_ms"],
            ms_hnsw=times["a_hnsw_ms"], bound_ms_popcount=popc_bound,
            shape=dict(shape, k=k_sel),
        ),
    }


def compare_select(case, lattice, label, planted=False):
    """Kernel D against its plain version: bitwise on lattice data; on
    Gaussian data the bin maxima within 1e-5 relative, the best
    candidate per query equal to kernel A's top-1 and, on every query D
    certifies (m2 < the 10th candidate), the stable top-10 equal to
    kernel A's top-10, scores and ids bit for bit. ``planted``: the case
    comes from :func:`plant_select_edges`. Returns the max abs
    difference of the bin maxima."""
    from redis_hnsw_tpu_torch.ops import cuda_scan, cuda_select

    qt, xt, sqm, qq = case
    sims, ids, m2 = cuda_select.select_bins(xt, sqm, qt, qq)
    ps, pi, pm2 = cuda_select.plain_select_bins(xt, sqm, qt, qq)
    torch.cuda.synchronize()
    fin = torch.isfinite(ps)
    check(torch.equal(fin, torch.isfinite(sims)),
          f"{label}: kernel D fills other bins than the plain version")
    err = (sims - ps)[fin].abs().max().item() if fin.any() else 0.0
    if lattice:
        for got, want, what in ((sims, ps, "sims"), (ids, pi, "ids"),
                                (m2, pm2, "m2")):
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{label}: kernel D {what} differ bitwise")
        if planted:
            same = ((xt[128:256] == qt[0]).all(1)
                    & torch.isfinite(sqm[128:256]))
            check((sims[:, 2] == float("-inf")).all().item()
                  and (ids[:, 2] == 256).all().item(),
                  f"{label}: kernel D's dead bin is not -inf at row 256")
            check(ids[0, 1].item() == 128 + int(same.int().argmax()) <= 140
                  and sims[0, 1].item() == 0.0 and m2[0].item() == 0.0,
                  f"{label}: kernel D's duplicate row: not the lowest id, "
                  f"or m2 != max1")
        return err
    rel = ((sims - ps).abs() / ps.abs().clamp(min=1.0))[fin]
    check(rel.max().item() <= 1e-5, f"{label}: kernel D bins off plain")
    best, pos = torch.sort(sims, dim=1, descending=True, stable=True)
    ti, ts = cuda_scan.flat_topk(qt, xt, sqm, qq, k=1)
    check(torch.equal(ids.gather(1, pos[:, :1]), ti)
          and torch.equal(best[:, :1].view(torch.int32),
                          ts.view(torch.int32)),
          f"{label}: kernel D's best candidate is not kernel A's top-1")
    if sims.shape[1] >= 10:
        top, top_ids = best[:, :10], ids.gather(1, pos[:, :10])
        ok = m2 < top[:, -1]
        ai, as_ = cuda_scan.flat_topk(qt, xt, sqm, qq, k=10)
        check(torch.equal(top_ids[ok], ai[ok])
              and torch.equal(top[ok].view(torch.int32),
                              as_[ok].view(torch.int32)),
              f"{label}: kernel D's certified top-10 is not kernel A's")
        log(f"phase 1: {label}: kernel D certifies {int(ok.sum())} of "
            f"{len(ok)} queries; their top-10 is kernel A's bit for bit")
    return err


def plant_select_edges(case):
    """Bin 2 (rows 256..383) all dead, and query 0 twice in bin 1 (rows
    140 and 150): kernel D must give the dead bin -inf at row 256, and
    for query 0 the lowest id of its copies with m2 == max1 == 0."""
    from redis_hnsw_tpu_torch.ops import distance as Dm

    qt, xt, sqm, _ = case
    sqm[256:384] = float("inf")
    xt[150] = qt[0] = xt[140]
    sqm[140] = sqm[150] = (xt[140] * xt[140]).sum()
    return qt, xt, sqm, Dm.sqnorms(qt)


def split_edge(plan, dev, B, delta):
    """(N, first boundary row): a table size N that ends ``delta`` rows
    past a split boundary of a launch of kernel A, B or D (as its module's
    ``plan`` cuts the 128-row tiles), with several splits of several
    tiles each."""
    for nt in range(2, 1 << 16):
        n = nt * 128 + delta
        splits, per = plan(dev, B, n)
        if splits > 1 and per > 1 and nt % per == 0:
            return n, per * 128
    raise CheckFailed("no split boundary found")


def phase_select(dev):
    """Kernel D: bitwise on lattice data at ragged shapes, at the edges of
    its 128 x 128 tile and of its splits, and at flat-sift1m's (B = 2048,
    N = 1,000,064, D = 128); on Gaussian data there its best candidate
    against kernel A's top-1 and its certified top-10 against kernel A's
    top-10; times beside the fp32 bound and a yardstick (torch.mm, then a
    per-bin amax)."""
    from redis_hnsw_tpu_torch.ops import cuda_select

    rng = np.random.default_rng(SEED + 6)
    err = 0.0
    edges = [(1, 129, 1), (127, 127, 33), (128, 128, 129), (129, 129, 128),
             (128, 1000, 1), (1, 5000, 129)]
    edges += [(129, split_edge(cuda_select.plan, dev, 129, delta)[0], D)
              for delta, D in ((-1, 128), (0, 33), (1, 128))]
    for B, N, D in edges:
        case = make_case(rng, B, N, D, True, 0.1, dev)
        if N > 256:
            case = plant_select_edges(case)
        err = max(err, compare_select(case, True, f"edge B={B} N={N} D={D}",
                                      planted=N > 256))
        del case
    log(f"phase 1: kernel D bitwise at its tile and split edges (B, N, D): "
        f"{edges}")
    shapes = [("ragged N=1000 B=3 dead", dict(B=3, N=1000, D=128,
                                              dead_frac=0.3)),
              ("ragged N=3001 B=70 D=33", dict(B=70, N=3001, D=33,
                                               dead_frac=0.1)),
              ("flat-sift1m shape", dict(B=2048, N=1_000_064, D=128,
                                         dead_frac=0.0001))]
    for label, kw in shapes:
        for lattice in (True, False):
            case = make_case(rng, lattice=lattice, dev=dev, **kw)
            err = max(err, compare_select(
                case, lattice, f"{label} {'lattice' if lattice else 'gauss'}"))
            del case
    log("phase 1: kernel D agrees with its plain version (bitwise on "
        "lattice data; on Gaussian data its best candidate is kernel A's "
        "top-1 and its certified top-10 kernel A's, bit for bit)")
    torch.cuda.empty_cache()
    B, N, D = 2048, 1_000_064, 128
    qt, xt, sqm, qq = make_case(rng, B, N, D, False, 0.0, dev)
    nbins = -(-N // cuda_select.BIN_L)
    splits, per = cuda_select.plan(dev, B, N)
    with ClockSampler() as clock:
        d_ms = sync_ms(lambda: cuda_select.select_bins(xt, sqm, qt, qq), 20)
    times = {
        "d_ms": d_ms,
        "d_plain_ms": sync_ms(lambda: cuda_select.plain_select_bins(
            xt, sqm, qt, qq), 2),
        "lib_ms": sync_ms(lambda: torch.mm(qt, xt.t()).view(
            B, nbins, cuda_select.BIN_L).amax(dim=2), 3),
    }
    log(f"phase 1: kernel D times at B={B} N={N} D={D} (ms; {splits} splits "
        f"of {per} bins per 128-query tile, "
        f"{cuda_select.block_slots(torch.cuda.current_device())} resident "
        f"blocks; while D ran: {clock.summary()}): " + json.dumps(times))
    bound, by = bound_ms(2.0 * B * N * D,
                         4.0 * (B * D + N * D + N + B) + 8.0 * B * nbins
                         + 4.0 * B)
    del qt, xt, sqm, qq
    torch.cuda.empty_cache()
    return dict(
        route="cuda", source="redis_hnsw_tpu_torch/csrc/select_bins.cu",
        replaces="redis_hnsw_tpu/ops/pallas_select.py:166",
        max_abs_err=err, ms=times["d_ms"], plain_ms=times["d_plain_ms"],
        bound_ms=bound, bound_by=by, library_ms=times["lib_ms"],
        shape={"B": B, "N": N, "D": D},
    )


def block_case(rng, dev, B, E, F, D, N, lattice, dtype, dead_frac=0.0):
    """Kernel C operands: q [B, D], qn [B], nbrvec [N, F, D] in ``dtype``,
    nbrsqn [N, F] and candidates [B, E] with ``dead_frac`` of them -1
    (the beam's spent slots, which the caller clamps and masks)."""
    from redis_hnsw_tpu_torch.ops import distance as Dm

    if lattice:
        q = rng.integers(-4, 5, (B, D)).astype(np.float32)
        x = rng.integers(-4, 5, (N, F, D)).astype(np.float32)
    else:
        q = rng.standard_normal((B, D)).astype(np.float32)
        x = rng.standard_normal((N, F, D)).astype(np.float32)
    cand = rng.integers(0, N, (B, E)).astype(np.int32)
    cand[rng.random((B, E)) < dead_frac] = -1
    qt = torch.from_numpy(q).to(dev)
    nbrvec = torch.from_numpy(x).to(dev).to(dtype)
    return (qt, Dm.sqnorms(qt), nbrvec, Dm.sqnorms(nbrvec.float()),
            torch.from_numpy(cand).to(dev))


def compare_block(case, lattice, label):
    """Kernel C vs its plain version with the beam's mask applied:
    bitwise on lattice data, within 1e-5 relative on Gaussian data.
    Returns the max abs difference."""
    from redis_hnsw_tpu_torch.ops import cuda_gather

    q, qn, nbrvec, nbrsqn, cand = case
    safe = cand.clamp(min=0)
    fresh = (cand >= 0).repeat_interleave(nbrvec.shape[1], dim=1)
    got = torch.where(fresh, cuda_gather.fused_block_score(
        q, qn, nbrvec, nbrsqn, safe), float("-inf"))
    want = torch.where(fresh, cuda_gather.plain_block_score(
        q, qn, nbrvec, nbrsqn, safe), float("-inf"))
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)),
          f"{label}: kernel C masks other slots than the plain version")
    err = (got - want)[fin].abs().max().item() if fin.any() else 0.0
    if lattice:
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"{label}: kernel C sims differ bitwise")
    else:
        rel = ((got - want).abs() / want.abs().clamp(min=1.0))[fin]
        worst = rel.max().item() if rel.numel() else 0.0
        check(worst <= 1e-5, f"{label}: kernel C off by {worst:.3g} rel")
    return err


def block_yardstick(q, qn, nbrvec, nbrsqn, cand):
    """Kernel C's function as plain PyTorch calls -- the block gather,
    torch.bmm against the queries, the sqnorm gather (the blocked path
    the JAX kernel was measured against, pallas_gather.py:18-25) -- the
    library yardstick; the port never calls it."""
    B, E = cand.shape
    F, D = nbrvec.shape[1], nbrvec.shape[2]
    c = cand.long()
    x = nbrvec[c].reshape(B, E * F, D)
    if x.dtype != torch.float32:
        x = x.float()
    dots = torch.bmm(x, q[:, :, None])[:, :, 0]
    return (2.0 * dots - qn[:, None]) - nbrsqn[c].reshape(B, E * F)


def offset_copy(t):
    """A copy of ``t`` 4 bytes past a 16-byte boundary."""
    step = 4 // t.element_size()
    buf = torch.empty(t.numel() + step, dtype=t.dtype, device=t.device)
    out = buf[step:].view(t.shape)
    out.copy_(t)
    return out


def phase_block_edges(dev):
    """Kernel C bitwise against its plain version on lattice data in
    f32/f16/bf16: F at 1/31/32/33/256, D at 1/24/33/129, B = 1, E =
    1/300, a candidate repeated within a lane, and the general form (a
    table and a query 4 bytes off a 16-byte boundary); then one Gaussian
    row planted at several (e, f) of several blocks, which every form
    (block, row, general, _entry_sims' narrowed rows) must score with
    the same bits at every copy. Returns the number of cases."""
    from redis_hnsw_tpu_torch.ops import cuda_gather
    from redis_hnsw_tpu_torch.ops import distance as Dm
    from redis_hnsw_tpu_torch.ops import search as Sr

    rng = np.random.default_rng(SEED + 5)
    shapes = [dict(B=4, E=3, F=f, D=128) for f in (1, 31, 32, 33)]
    shapes += [dict(B=2, E=2, F=256, D=128)]
    shapes += [dict(B=5, E=4, F=32, D=d) for d in (1, 24, 33, 129)]
    shapes += [dict(B=1, E=16, F=32, D=128), dict(B=3, E=1, F=32, D=128),
               dict(B=2, E=300, F=32, D=64), dict(B=2, E=300, F=1, D=128)]
    cases = 0
    forms = cuda_gather.fused_block_score.forms
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype)[6:]
        for kw in shapes:
            case = block_case(rng, dev, N=60, lattice=True, dtype=dtype,
                              dead_frac=0.2, **kw)
            compare_block(case, True, f"edge {kw} {name}")
            cases += 1
        # a candidate repeated within a lane and across lanes
        q, qn, nbrvec, nbrsqn, cand = block_case(
            rng, dev, 64, 16, 32, 128, 50, True, dtype)
        cand[:, 3:9] = cand[:, 2:3]
        cand[5:9] = cand[4]
        compare_block((q, qn, nbrvec, nbrsqn, cand), True,
                      f"repeated candidates {name}")
        per = cuda_gather.fused_block_score(q, qn, nbrvec, nbrsqn, cand)
        per = per.view(64, 16, 32).view(torch.int32)
        check(all(torch.equal(per[:, e], per[:, 2]) for e in range(3, 9)),
              f"repeated candidates {name}: copies differ")
        # the general form: unaligned operands
        for F in (1, 32):
            q, qn, nbrvec, nbrsqn, cand = block_case(
                rng, dev, 9, 7, F, 128, 40, True, dtype)
            key = f"{'row' if F == 1 else 'block'}/direct"
            before = forms[key]
            for args in ((q, qn, offset_copy(nbrvec), nbrsqn, cand),
                         (offset_copy(q), qn, nbrvec, nbrsqn, cand)):
                compare_block(args, True, f"unaligned F={F} {name}")
            check(forms[key] == before + 2,
                  f"unaligned F={F} {name}: the general form did not run")
        cases += 5

        # position independence on Gaussian data
        B, E, F, D, N = 40, 16, 32, 128, 300
        q, qn, nbrvec, nbrsqn, cand = block_case(rng, dev, B, E, F, D, N,
                                                 False, dtype)
        star = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
        star = star.to(dev)
        star_sq = Dm.sqnorms(star.to(dtype).float()[None])[0]
        spots = [(7, 0), (7, 31), (19, 5), (101, 17), (250, 30)]
        for blk, f in spots:
            nbrvec[blk, f] = star.to(dtype)
            nbrsqn[blk, f] = star_sq
        cand[:, :5] = torch.tensor([b for b, _ in spots], dtype=torch.int32,
                                   device=dev)
        per = cuda_gather.fused_block_score(q, qn, nbrvec, nbrsqn,
                                            cand).view(B, E, F)
        copies = [per[:, e, f] for e, (_, f) in enumerate(spots)]
        ids = torch.tensor([b * F + f for b, f in spots], dtype=torch.int32,
                           device=dev).repeat(B, 1)
        rows = cuda_gather.fused_row_score(q, qn, nbrvec.view(N * F, D),
                                           nbrsqn.view(N * F), ids)
        copies += list(rows.t())
        gen = cuda_gather.fused_block_score(q, qn, offset_copy(nbrvec),
                                            nbrsqn, cand).view(B, E, F)
        copies += [gen[:, 0, 0], gen[:, 4, 30]]
        vecs = torch.zeros((N, D), device=dev)
        vecs[[3, 77]] = star
        vn = torch.zeros(N, device=dev)
        vn[[3, 77]] = star_sq
        entry = Sr._entry_sims(
            q, qn, vecs, vn,
            torch.tensor([[3, 77]], dtype=torch.int32, device=dev).repeat(
                B, 1),
            torch.ones((B, 2), dtype=torch.bool, device=dev), dtype)
        copies += list(entry.t())
        torch.cuda.synchronize()
        check(all(torch.equal(c.view(torch.int32), copies[0].view(torch.int32))
                  for c in copies),
              f"position independence {name}: a planted row's copies differ")
        cases += 1
    log(f"phase 1: kernel C: {cases} edge cases bitwise equal to its plain "
        f"version on lattice data (F 1/31/32/33/256, D 1/24/33/129, B 1, E "
        f"1/300, repeated candidates, the general form on unaligned "
        f"operands), and a planted Gaussian row scored with the same bits "
        f"at {len(copies)} copies across blocks, positions and forms, in "
        f"f32/f16/bf16; launches by form {dict(forms)}")
    return cases


def block_bytes(B, E, F, D, elem):
    """Bytes kernel C must move: each block row read once, its sqnorm,
    the output, q, qn and the candidate ids."""
    return (B * E * F * D * elem + B * E * F * 4 * 2 + B * D * 4 + B * 4
            + B * E * 4)


def phase_block_score(dev, n=1_000_064, main_n=20_000):
    """Kernel C: ragged and main-shape checks, the edge cases, then times
    over a SIFT1M-size block table built by the snapshot's own
    _build_nbrvec (f32, f16, bf16; B = 2048 and 16) and over its rows
    (the row form, J = 512 and 16), each beside its byte bound, its plain
    version and its library yardstick."""
    from redis_hnsw_tpu_torch.ops import cuda_gather
    from redis_hnsw_tpu_torch.ops import distance as Dm
    from redis_hnsw_tpu_torch.ops.snapshot import _build_nbrvec

    rng = np.random.default_rng(SEED + 2)
    err = 0.0
    shapes = [("ragged B=3 E=1 F=8 D=24", dict(B=3, E=1, F=8, D=24, N=50)),
              ("main B=2048 E=16 F=32 D=128",
               dict(B=2048, E=16, F=32, D=128, N=main_n))]
    for label, kw in shapes:
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            for lattice in (True, False):
                tag = (f"{label} {str(dtype)[6:]} "
                       f"{'lattice' if lattice else 'gaussian'}")
                case = block_case(rng, dev, lattice=lattice, dtype=dtype,
                                  dead_frac=0.2, **kw)
                err = max(err, compare_block(case, lattice, tag))
                del case
    log("phase 1: kernel C agrees with its plain version (bitwise on "
        "lattice data in f32/f16/bf16, 1e-5 relative on Gaussian data)")
    phase_block_edges(dev)

    D, F, B, E = 128, 32, 2048, 16
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    vecs = torch.randn((n, D), generator=g, device=dev)
    sq = Dm.sqnorms(vecs)
    adj0 = torch.randint(0, n, (n, F), generator=g, device=dev,
                         dtype=torch.int32)
    q = torch.randn((B, D), generator=g, device=dev)
    qn = Dm.sqnorms(q)
    cand = torch.randint(0, n, (B, E), generator=g, device=dev,
                         dtype=torch.int32)
    ids = torch.randint(0, n, (B, 512), generator=g, device=dev,
                        dtype=torch.int32)
    q16, qn16, c16 = (t[:16].contiguous() for t in (q, qn, cand))
    rows, clocks = {}, {}

    def time_case(label, case, elem, reps, timer=sync_ms):
        Bc, Ec = case[4].shape
        Fc = case[2].shape[1]
        bound, by = bound_ms(2.0 * Bc * Ec * Fc * D,
                             block_bytes(Bc, Ec, Fc, D, elem))
        rows[label] = dict(
            ms=timer(lambda: cuda_gather.fused_block_score(*case), reps),
            plain_ms=sync_ms(lambda: cuda_gather.plain_block_score(*case), 3),
            library_ms=sync_ms(lambda: block_yardstick(*case), 3),
            bound_ms=bound, bound_by=by)

    for dtype in (torch.float16, torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        t0 = time.perf_counter()
        nbrvec, nbrsqn = _build_nbrvec(vecs, sq, adj0, dtype=dtype)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        case = (q, qn, nbrvec, nbrsqn, cand)
        err = max(err, compare_block(case, False, f"sift1m {name}"))
        # ~0.3-0.6 s of launches, long enough for the clock samples
        with ClockSampler() as clocks[name]:
            time_case(name, case, nbrvec.element_size(), 3000)
        if dtype != torch.bfloat16:
            time_case(f"{name} B=16", (q16, qn16, nbrvec, nbrsqn, c16),
                      nbrvec.element_size(), 50, graph_ms)
        log(f"phase 1: kernel C over a {tuple(nbrvec.shape)} {name} table "
            f"({nbrvec.numel() * nbrvec.element_size()} bytes, built in "
            f"{build_s:.2f} s): {json.dumps(rows[name])}; while timed: "
            f"{clocks[name].summary()}")
        del nbrvec, nbrsqn, case
        torch.cuda.empty_cache()
    # the row form over the table's rows
    for dtype in (torch.float32, torch.float16):
        name = str(dtype)[6:]
        table = vecs.to(dtype)
        for J in (512, 16):
            jid = ids[:, :J].contiguous()
            case = (q, qn, table.unsqueeze(1), sq.unsqueeze(1), jid)
            err = max(err, compare_block(case, False, f"rows J={J} {name}"))
            want = cuda_gather.fused_block_score(*case)
            got = cuda_gather.fused_row_score(q, qn, table, sq, jid)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"rows J={J} {name}: fused_row_score differs")
            if dtype == torch.float32 or J == 512:
                time_case(f"{name} rows J={J}", case, table.element_size(),
                          *((200,) if J == 512 else (50, graph_ms)))
        del table
    del vecs, sq, adj0
    torch.cuda.empty_cache()
    log("phase 1: kernel C times (ms; bound by bytes; plain = the plain "
        "version, library = gather + torch.bmm + sqnorm gather; B = 16 and "
        "J = 16 as CUDA graphs of 50 launches): "
        + json.dumps(rows))
    f32 = rows["float32"]
    return dict(
        route="cuda", source="redis_hnsw_tpu_torch/csrc/block_score.cu",
        replaces="redis_hnsw_tpu/ops/pallas_gather.py:98",
        max_abs_err=err, ms=f32["ms"], plain_ms=f32["plain_ms"],
        bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
        library_ms=f32["library_ms"],
        library_calls="nbrvec[cand], torch.bmm, nbrsqn[cand]",
        shape=dict(B=B, E=E, F=F, D=D, N=n), shapes=rows,
    )


# -- phases 2 and 3: the main path ----------------------------------------

def oracle_dists(xs64, live, qs):
    """float64 squared distances [B, N] of the queries to every row,
    +inf on deleted rows."""
    q64 = torch.as_tensor(qs, dtype=torch.float64, device=xs64.device)
    d = ((q64 * q64).sum(1)[:, None] + (xs64 * xs64).sum(1)[None, :]
         - 2.0 * q64 @ xs64.t())
    d[:, torch.from_numpy(~live).to(xs64.device)] = float("inf")
    return d


def reply_check(d, live, row_of, names, sims, k, label):
    """Each of the first B replies holds k distinct live names, nearest
    first, whose sims match the float64 distances ``d`` (numpy [B, N])
    to 1e-5 relative. Returns the rows of those replies [B, k]."""
    out = np.empty((d.shape[0], k), np.int64)
    for b in range(d.shape[0]):
        rows = [row_of.get(n, -1) for n in names[b]]
        check(len(rows) == k and len(set(rows)) == k and min(rows) >= 0,
              f"{label}: query {b} reply is not {k} distinct live names")
        check(all(live[r] for r in rows),
              f"{label}: query {b} returned a deleted row")
        check(np.allclose(-d[b, rows], sims[b], rtol=1e-5, atol=1e-5),
              f"{label}: query {b} sims off the oracle")
        check((np.diff(sims[b]) <= 0).all(),
              f"{label}: query {b} not nearest first")
        out[b] = rows
    return out


def oracle_check(xs64, live, qs, names_of_row, names, sims, k, label):
    """Replies against a float64 brute force over the live rows: each
    reply holds k distinct live names, nearest first, whose distances
    are within the k-th oracle distance (ties allowed) and whose sims
    match the float64 distances to 1e-5 relative."""
    d = oracle_dists(xs64, live, qs)
    kth = torch.topk(d, k, dim=1, largest=False).values[:, -1].cpu().numpy()
    d = d.cpu().numpy()
    row_of = {n: i for i, n in enumerate(names_of_row)}
    rows = reply_check(d, live, row_of, names, sims, k, label)
    for b in range(len(qs)):
        tol = 1e-5 * max(1.0, abs(kth[b]))
        check((d[b, rows[b]] <= kth[b] + tol).all(),
              f"{label}: query {b} missed a nearer row")


# bench.py's (ef, iters) operating-point sweep for the graph engine
GRAPH_SWEEP = ((256, 16), (256, 20), (256, 24), (320, 24), (400, 28),
               (512, 36))
GRAPH_RECALL = 0.95


class GraphOracle:
    """float64 ground truth of one query block for graph replies."""

    def __init__(self, xs64, live, qs, names_of_row, k):
        d = oracle_dists(xs64, live, qs)
        self.truth = torch.topk(d, k, dim=1, largest=False).indices.cpu()
        self.truth = self.truth.numpy()
        self.d = d.cpu().numpy()
        self.live = live
        self.k = k
        self.row_of = {n: i for i, n in enumerate(names_of_row)}

    def recall(self, names, sims, label):
        """recall@k of a columnar graph reply, after reply_check."""
        rows = reply_check(self.d, self.live, self.row_of, names, sims,
                           self.k, label)
        hits = sum(len(set(r.tolist()) & set(t.tolist()))
                   for r, t in zip(rows, self.truth))
        return hits / rows.size


def graph_sweep(client, name, qs, oracle, k, label, start=0):
    """Walk GRAPH_SWEEP from ``start`` to the first point with
    recall@k >= GRAPH_RECALL; fails if none reaches it. Returns
    (index into the sweep, recall, reply)."""
    seen = []
    for i in range(start, len(GRAPH_SWEEP)):
        ef, iters = GRAPH_SWEEP[i]
        reply = client.search_batch(name, qs, k=k, engine="graph",
                                    ef_search=ef, iters=iters, expand=16,
                                    reply="columnar")
        r = oracle.recall(*reply, f"{label} ef={ef} iters={iters}")
        seen.append((ef, iters, r))
        if r >= GRAPH_RECALL:
            return i, r, reply
    raise CheckFailed(f"{label}: no sweep point reaches recall@{k} "
                      f">= {GRAPH_RECALL}: {seen}")


def _counters():
    from redis_hnsw_tpu_torch.ops import (
        cuda_count,
        cuda_gather,
        cuda_scan,
        cuda_select,
    )

    return {"scan_topk": cuda_scan.flat_topk,
            "scan_topk_hamming": cuda_scan.flat_topk_hamming,
            "count_gt_eq": cuda_count.count_gt_eq,
            "block_score": cuda_gather.fused_block_score,
            "select_bins": cuda_select.select_bins}


def reset_counts():
    from redis_hnsw_tpu_torch.ops import cuda_gather

    for fn in _counters().values():
        fn.launches = 0
    cuda_gather.fused_block_score.forms.clear()


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def bulk_build(client, name, names, data, batch_size=2048):
    """``add_batch`` of the rows into index ``name`` with the build's phase
    timer on (each phase ends in a device sync); returns its seconds, the
    phase breakdown, the index's snapshot refreshes by kind and the
    kernels' launches (C's also by form) during the build."""
    from collections import Counter

    from redis_hnsw_tpu_torch.ops import construct, cuda_gather
    from redis_hnsw_tpu_torch.utils.profiling import PhaseTimer

    before = read_counts()
    forms = Counter(cuda_gather.fused_block_score.forms)
    construct.BUILD_TIMER = timer = PhaseTimer()
    try:
        t0 = time.perf_counter()
        client.add_batch(name, names, data, batch_size=batch_size)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        construct.BUILD_TIMER = None
    return {
        "s": secs, "phases": timer.summary(),
        "refreshes": dict(client.index(name).snapshot_refreshes),
        "launches": {k: v - before[k] for k, v in read_counts().items()},
        "forms": dict(cuda_gather.fused_block_score.forms - forms),
    }


def phase_hnsw(client, dev, n=10_000, n_q=2048):
    from redis_hnsw_tpu_torch.ops import cuda_gather

    dim, k = 128, 10
    rng = np.random.default_rng(SEED)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((n_q, dim)).astype(np.float32)
    names = [f"v{i}" for i in range(n)]
    xs64 = torch.from_numpy(data).to(dev, torch.float64)
    live = np.ones(n, bool)
    reset_counts()
    client.create_index("hnsw-main", dim=dim, m=16, ef_construction=200,
                        seed=SEED, backend="native")
    build = bulk_build(client, "hnsw-main", names, data)
    check(build["launches"]["scan_topk"] > 0
          and build["launches"]["block_score"] > 0,
          f"hnsw-main: a kernel never launched in the bulk build: {build}")
    check(build["refreshes"]["full"] == 1,
          f"hnsw-main: the bulk build rebuilt its snapshot: {build}")
    # the add_node build of the same rows, timed beside it
    client.create_index("hnsw-main-seq", dim=dim, m=16, ef_construction=200,
                        seed=SEED, backend="native")
    t0 = time.perf_counter()
    for i in range(n):
        client.add_node("hnsw-main-seq", names[i], data[i])
    seq_s = time.perf_counter() - t0
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
    oracle_check(xs64, live, qs, names, cnames, csims, k, "hnsw-main")

    # the graph engine (kernel C) on the same index and queries
    oracle = GraphOracle(xs64, live, qs, names, k)
    t0 = time.perf_counter()
    at, g_recall, _ = graph_sweep(client, "hnsw-main", qs, oracle, k,
                                  "hnsw-main graph")
    sweep_s = time.perf_counter() - t0
    ef, iters = GRAPH_SWEEP[at]
    gkw = dict(k=k, engine="graph", ef_search=ef, iters=iters, expand=16,
               reply="columnar")
    c0 = cuda_gather.fused_block_score.launches
    graph_s, (gnames, gsims) = timed(
        lambda: client.search_batch("hnsw-main", qs, **gkw), 3)
    per_batch = (cuda_gather.fused_block_score.launches - c0) / 4
    check(per_batch > 0, "hnsw-main: kernel C never launched")
    g_recall2 = oracle.recall(gnames, gsims, "hnsw-main graph timed")
    check(g_recall2 == g_recall, "hnsw-main: graph replies not repeatable")
    seq_recall = oracle.recall(
        *client.search_batch("hnsw-main-seq", qs, **gkw),
        "hnsw-main add_node graph")
    client.delete_index("hnsw-main-seq")

    victims = rng.choice(n, 100, replace=False)
    for v in victims:
        client.delete_node("hnsw-main", names[v])
    dnames, dsims = client.search_batch("hnsw-main", qs, k=k,
                                        reply="columnar")
    dead = {names[v] for v in victims}
    check(not dead & set(dnames.ravel().tolist()),
          "hnsw-main: a deleted name was served")
    live[victims] = False
    oracle_check(xs64, live, qs, names, dnames, dsims, k,
                 "hnsw-main after deletes")
    oracle = GraphOracle(xs64, live, qs, names, k)
    d_at, d_recall, (gdn, _) = graph_sweep(
        client, "hnsw-main", qs, oracle, k, "hnsw-main graph after deletes")
    check(not dead & set(gdn.ravel().tolist()),
          "hnsw-main: the graph engine served a deleted name")

    # the other frontier tiers; a delete rebuilds the snapshot in them
    tiers = {}
    for tier in ("f16", "off"):
        os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"] = tier
        try:
            extra = int(rng.choice(np.flatnonzero(live)))
            client.delete_node("hnsw-main", names[extra])
            live[extra] = False
            snap = client.index("hnsw-main").device_snapshot()
            want = None if tier == "off" else torch.float16
            check((snap.nbrvec is None) == (want is None)
                  and (want is None or snap.nbrvec.dtype == want),
                  f"hnsw-main: the {tier} tier was not built")
            oracle = GraphOracle(xs64, live, qs, names, k)
            t_at, t_recall, _ = graph_sweep(
                client, "hnsw-main", qs, oracle, k, f"hnsw-main graph {tier}")
            t_s, _ = timed(lambda: client.search_batch(
                "hnsw-main", qs, k=k, engine="graph",
                ef_search=GRAPH_SWEEP[t_at][0], iters=GRAPH_SWEEP[t_at][1],
                expand=16, reply="columnar"), 2)
            tiers[tier] = (GRAPH_SWEEP[t_at], t_recall, n_q / t_s)
        finally:
            del os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"]
    counts = read_counts()
    c_forms = dict(cuda_gather.fused_block_score.forms)
    check(counts["scan_topk"] > 0, "hnsw-main: kernel A never launched")
    check(counts["block_score"] > 0, "hnsw-main: kernel C never launched")
    del xs64
    log(f"phase 2: hnsw-main: built {n} rows by add_batch(batch_size=2048) "
        f"in {build['s']:.3f} s ({n / build['s']:.1f} inserts/s; phases "
        f"{json.dumps(build['phases'])}; snapshot refreshes "
        f"{build['refreshes']}; build launches {build['launches']}, kernel "
        f"C's by form {build['forms']}); the same rows by add_node in "
        f"{seq_s:.3f} s ({n / seq_s:.1f} inserts/s), that graph's recall@{k} "
        f"at the chosen point {seq_recall:.4f}; scan search_batch {n_q} queries "
        f"k={k}: first call {first_s * 1e3:.1f} ms (snapshot + kernel load), "
        f"columnar {n_q / col_s:.0f} qps, objects {n_q / obj_s:.0f} qps; "
        f"replies match the float64 oracle before and after 100 deletes")
    log(f"phase 2: hnsw-main graph engine (expand=16, f32 blocks): sweep "
        f"{sweep_s:.2f} s, chosen ef={ef} iters={iters} recall@{k}="
        f"{g_recall:.4f}, columnar {n_q / graph_s:.0f} qps "
        f"({graph_s * 1e3:.1f} ms per {n_q}-query batch), kernel C "
        f"{per_batch:.0f} launches per batch; after 100 deletes "
        f"ef={GRAPH_SWEEP[d_at][0]} iters={GRAPH_SWEEP[d_at][1]} recall@{k}="
        f"{d_recall:.4f}, no deleted name served; tiers (ef, iters), "
        f"recall, qps: {tiers}; launches {counts}; kernel C's by call and "
        f"form {c_forms}")
    client.delete_index("hnsw-main")
    return counts, c_forms


def graph_state(idx):
    """What a build decides, comparable across devices: max_layer,
    enterpoint, levels, every row's neighbour list at every layer in
    order, and the snapshot's adjacency tables' bytes."""
    hw = idx._names.high_water
    snap = idx.device_snapshot()
    return (idx.max_layer, idx.enterpoint, idx._levels[:hw].tobytes(),
            [[idx._nbrs(r, lc) for lc in range(int(idx._levels[r]) + 1)]
             for r in range(hw)],
            [t.cpu().numpy().tobytes()
             for t in (snap.adj0, snap.adj_up, snap.upper_of)])


def phase_graph_lattice(dev, n=2000, n_q=256, devices=("cuda", "cpu")):
    """Graph-engine replies on the card (kernel C) against the same
    index's replies on the CPU (plain versions): byte for byte on
    integer-lattice data, f32 and f16 blocks, expand 1 and 16, seeds."""
    import redis_hnsw_tpu_torch as h

    dim = 32
    rng = np.random.default_rng(SEED + 3)
    data = rng.integers(-4, 5, (n, dim)).astype(np.float32)
    qs = rng.integers(-4, 5, (n_q, dim)).astype(np.float32)
    clients = [h.HNSW(device=d) for d in devices]
    for c in clients:
        c.create_index("lat", dim=dim, m=8, ef_construction=64, seed=SEED)
        for i in range(n):
            c.add_node("lat", f"l{i}", data[i])
    reset_counts()
    checked = 0
    for j, tier in enumerate(("f32", "f16")):
        os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"] = tier
        try:
            for c in clients:  # a mutation rebuilds the tier
                c.delete_node("lat", f"l{j * 7}")
            for kw in (dict(expand=1), dict(expand=16),
                       dict(expand=16, seeds=4), dict(expand=1, seeds=4)):
                got = [c.search_batch("lat", qs, k=10, engine="graph",
                                      reply="columnar", **kw)
                       for c in clients]
                check(np.array_equal(got[0][0], got[1][0])
                      and np.array_equal(got[0][1].view(np.int32),
                                         got[1][1].view(np.int32)),
                      f"graph-lattice: card and CPU replies differ ({tier}, "
                      f"{kw})")
                checked += 1
        finally:
            del os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"]
    counts = read_counts()
    check(counts["block_score"] > 0 and counts["scan_topk"] > 0,
          f"graph-lattice: a kernel never launched: {counts}")
    log(f"phase 2b: graph-lattice: {n} x {dim} lattice index, {n_q} "
        f"queries: card replies equal the CPU's byte for byte in {checked} "
        f"configurations (f32/f16 blocks, expand 1/16, seeds 0/4); "
        f"launches {counts}")
    # bulk builds of the same rows, 512-row waves (the last one partial):
    # the card's graph equals the CPU's byte for byte
    names = [f"l{i}" for i in range(n)]
    bulk = {}
    for l0 in ("scan", "beam"):
        os.environ["REDIS_HNSW_TPU_BUILD_L0"] = l0
        try:
            reset_counts()
            states = []
            for c in clients:
                c.create_index("latb", dim=dim, m=8, ef_construction=64,
                               seed=SEED)
                c.add_batch("latb", names, data, batch_size=512)
                states.append(graph_state(c.index("latb")))
                c.delete_index("latb")
            bulk[l0] = read_counts()
        finally:
            del os.environ["REDIS_HNSW_TPU_BUILD_L0"]
        check(states[0] == states[1],
              f"graph-lattice: the card's bulk build ({l0}) differs from "
              f"the CPU's")
        check(bulk[l0]["block_score"] > 0
              and (l0 == "beam" or bulk[l0]["scan_topk"] > 0),
              f"graph-lattice: a kernel never launched in the {l0} bulk "
              f"build: {bulk[l0]}")
    log(f"phase 2b: graph-lattice bulk builds (add_batch, 512-row waves, the "
        f"last partial; BUILD_L0 scan and beam): the card's graph equals the "
        f"CPU's byte for byte (levels, enterpoint, max_layer, every row's "
        f"neighbour list at every layer in order, the snapshot's adjacency "
        f"tables); launches {bulk}")
    return {name: bulk["scan"][name] + bulk["beam"][name] for name in bulk["scan"]}


class ChunkedOracle:
    """float64 ground truth of a query block over a large table, computed
    on the card in query chunks: each query's k nearest rows and its
    k-th distance."""

    def __init__(self, xs64, qs, k, chunk=256):
        self.xs64, self.k = xs64, k
        self.q64 = torch.from_numpy(qs).to(xs64.device, torch.float64)
        xn = (xs64 * xs64).sum(1)
        truth, kth = [], []
        for lo in range(0, len(qs), chunk):
            q = self.q64[lo : lo + chunk]
            d = (q * q).sum(1)[:, None] + xn[None, :] - 2.0 * q @ xs64.t()
            v, i = torch.topk(d, k, dim=1, largest=False)
            truth.append(i.cpu())
            kth.append(v[:, -1].cpu())
        self.truth = torch.cat(truth).numpy()
        self.kth = torch.cat(kth).numpy()

    def recall(self, row_of, names, sims, label):
        """(recall@k, whether every reply is exact, queries answered with
        fewer than k names) of a columnar reply. A reply's names are
        distinct live rows, nearest first, with sims within 1e-5 of the
        float64 distances; empty slots (None / -inf, a beam that found
        fewer than k rows) may only trail, and count as misses."""
        rows = np.array([[row_of.get(x, -1) for x in r]
                         for r in names.tolist()])
        valid = rows >= 0
        check(np.array_equal(valid, np.isfinite(sims))
              and (valid[:, :-1] >= valid[:, 1:]).all(),
              f"{label}: empty slots are not a reply's tail")
        for r, ok in zip(rows, valid):
            check(len(set(r[ok].tolist())) == ok.sum(),
                  f"{label}: a reply repeats a name")
        rt = torch.from_numpy(np.maximum(rows, 0)).to(self.xs64.device)
        d = ((self.q64[:, None, :] - self.xs64[rt]) ** 2).sum(-1).cpu()
        d = d.numpy()
        check(np.allclose(-d[valid], sims[valid], rtol=1e-5, atol=1e-5),
              f"{label}: sims off the float64 oracle")
        check((np.diff(np.where(valid, sims, -np.inf), axis=1) <= 0)[
            valid[:, 1:]].all(), f"{label}: replies not nearest first")
        hits = sum(len(set(r[ok].tolist()) & set(t.tolist()))
                   for r, ok, t in zip(rows, valid, self.truth))
        tol = 1e-5 * np.maximum(1.0, np.abs(self.kth))
        exact = bool((d <= (self.kth + tol)[:, None])[valid].all())
        return hits / rows.size, exact, int((~valid.all(1)).sum())


# graph-engine points of phase 2d: ef_search, iters (expand = 16). The
# first two are always served; the rest, each with ~ef/16 + 8 steps, only
# until one reaches GRAPH_RECALL.
BUILD_SERVE_POINTS = ((128, 20), (256, 20), (512, 40), (1024, 72),
                      (2048, 136))


def phase_build(client, dev, n=262_144, n_q=2048, gate=True):
    """2d: hnsw-build-sift1m-shape -- add_batch(batch_size=2048) of n x 128
    seeded Gaussian rows (SIFT1M's width; n = a quarter of its rows by
    default), M=16, efcon=200, native host core: inserts/s, the phase
    breakdown, one full snapshot build and deltas after it, kernel A
    timed at the build's shape (2048 lanes over the final table, k = 64,
    scan-l0's fetch width) beside its bound, its plain version and
    torch.mm + torch.topk; then n_q queries served by the exact tier and
    the graph engine, against a float64 oracle. ``gate``: the graph engine
    must reach GRAPH_RECALL at a point of BUILD_SERVE_POINTS (at other
    sizes than the default the sweep's recalls are only logged: on iid
    Gaussian rows they fall as the table grows). Returns (the launches of
    the build and the serving, kernel A's row at the build shape)."""
    from redis_hnsw_tpu_torch.ops import cuda_scan
    from redis_hnsw_tpu_torch.ops import distance as Dm

    name, dim, k = "hnsw-build-sift1m-shape", 128, 10
    rng = np.random.default_rng(SEED + 9)
    data = rng.standard_normal((n, dim), dtype=np.float32)
    qs = rng.standard_normal((n_q, dim), dtype=np.float32)
    names = [f"b{i}" for i in range(n)]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    client.create_index(name, dim=dim, m=16, ef_construction=200, seed=SEED,
                        backend="native")
    build = bulk_build(client, name, names, data)
    peak = torch.cuda.max_memory_allocated()
    idx = client.index(name)
    check(idx.node_count == n, f"{name}: {idx.node_count} rows, not {n}")
    check(build["refreshes"]["full"] == 1,
          f"{name}: the snapshot was rebuilt mid-build: {build['refreshes']}")
    check(build["launches"]["scan_topk"] > 0
          and build["launches"]["block_score"] > 0,
          f"{name}: a kernel never launched in the build: {build}")
    snap = idx.device_snapshot()
    # rows left with no layer-0 link: every link of theirs was pruned by
    # their neighbours' degree caps (the reference's bidirectional shrink)
    isolated = int((snap.adj0[:n] < 0).all(1).sum())
    log(f"phase 2d: {name}: add_batch(batch_size=2048) of {n} x {dim} rows "
        f"in {build['s']:.3f} s ({n / build['s']:.1f} inserts/s); phases "
        f"{json.dumps(build['phases'])}; snapshot refreshes "
        f"{build['refreshes']}; build launches {build['launches']}, kernel "
        f"C's by form {build['forms']}; max_memory_allocated {peak} bytes; "
        f"max_layer {idx.max_layer}, rows with no layer-0 link {isolated}, "
        f"frontier tier {snap.nbrvec.dtype if snap.nbrvec is not None else None}")

    # kernel A at the build's shape: scan-l0's call on the final table
    live = torch.zeros(snap.n_pad, dtype=torch.bool, device=dev)
    live[:n] = True
    qt = torch.from_numpy(data[-n_q:]).to(dev)
    case = (qt, snap.vecs, cuda_scan.euclid_sq_masked(snap.sqnorms, live),
            Dm.sqnorms(qt))
    fetch_c = 64
    err = compare_topk(case, fetch_c, False, f"{name} kernel A k={fetch_c}")
    B, N = qt.shape[0], snap.n_pad
    a_bound, a_by = bound_ms(2.0 * B * N * dim, 4.0 * (B * dim + N * dim + N
                                                       + B) + 8.0 * B * fetch_c)
    a_row = dict(
        ms=sync_ms(lambda: cuda_scan.flat_topk(*case, k=fetch_c), 10),
        plain_ms=sync_ms(lambda: cuda_scan.plain_flat_topk(*case, k=fetch_c),
                         2),
        library_ms=sync_ms(lambda: torch.topk(torch.mm(qt, snap.vecs.t()),
                                              fetch_c, dim=1), 3),
        bound_ms=a_bound, bound_by=a_by, max_abs_err=err,
        shape=dict(B=B, N=N, D=dim, k=fetch_c))
    log(f"phase 2d: kernel A at the build's shape {a_row['shape']}: "
        f"{json.dumps(a_row)}")
    del case, qt, live

    # serve: the exact tier, then the graph engine
    xs64 = torch.from_numpy(data).to(dev, torch.float64)
    t0 = time.perf_counter()
    oracle = ChunkedOracle(xs64, qs, k)
    oracle_s = time.perf_counter() - t0
    row_of = {nm: i for i, nm in enumerate(names)}
    reset_counts()
    scan_s, (snames, ssims) = timed(lambda: client.search_batch(
        name, qs, k=k, engine="scan", reply="columnar"), 1)
    s_recall, exact, short = oracle.recall(row_of, snames, ssims,
                                           f"{name} scan")
    check(exact and short == 0 and s_recall >= GRAPH_RECALL,
          f"{name}: the exact tier missed a nearer row ({s_recall}, "
          f"{short} short replies)")
    points = []
    for i, (ef, iters) in enumerate(BUILD_SERVE_POINTS):
        if i >= 2 and points[-1]["recall"] >= GRAPH_RECALL:
            break
        g_s, (gnames, gsims) = timed(lambda: client.search_batch(
            name, qs, k=k, engine="graph", ef_search=ef, iters=iters,
            expand=16, reply="columnar"), 1)
        r, _, short = oracle.recall(row_of, gnames, gsims,
                                    f"{name} graph ef={ef} iters={iters}")
        points.append(dict(ef=ef, iters=iters, recall=r, qps=n_q / g_s,
                           short_replies=short))
    serve = read_counts()
    check(not gate or points[-1]["recall"] >= GRAPH_RECALL,
          f"{name}: the graph engine reaches recall@{k} < {GRAPH_RECALL} at "
          f"every point: {points}")
    del xs64
    client.delete_index(name)
    log(f"phase 2d: {name}: {n_q} queries k={k}: exact tier recall@{k} "
        f"{s_recall:.4f}, {n_q / scan_s:.1f} qps, every reply within the "
        f"float64 oracle's k-th distance ({oracle_s:.1f} s); graph engine "
        f"(expand=16): {json.dumps(points)}; serving launches {serve}")
    return ({key: build["launches"][key] + serve[key] for key in serve},
            a_row)


def phase_flat(client, dev, b_ms, d_ms):
    """3: flat-sift1m on the certified tier's two-pass form (kernels A and
    B), byte-identical to the exact tier; kernel B's share of the batch
    time is its launches times ``b_ms``, its phase 1 time at this shape
    (2048 queries over 1,000,064 rows). Then 3c (:func:`phase_onepass`)."""
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
    os.environ["REDIS_HNSW_TPU_CERT_ONEPASS"] = "0"  # the two-pass form
    try:
        reset_counts()
        t0 = time.perf_counter()
        cnames, csims = idx.search_batch(qs, k, reply="columnar")
        first_s = time.perf_counter() - t0
        counts = read_counts()
        t0 = time.perf_counter()
        cnames2, csims2 = idx.search_batch(qs, k, reply="columnar")
        cert_s = time.perf_counter() - t0
    finally:
        del os.environ["REDIS_HNSW_TPU_CERT_ONEPASS"]
    check(counts["scan_topk"] > 0 and counts["count_gt_eq"] > 0,
          f"flat-sift1m: a kernel never launched: {counts}")
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
    b_share = counts["count_gt_eq"] * b_ms / (cert_s * 1e3)
    log(f"phase 3: flat-sift1m: add_batch {n} rows {add_s:.2f} s; "
        f"search_batch {n_q} queries k={k} certified two-pass: first call "
        f"{first_s:.3f} s (table upload), then {n_q / cert_s:.0f} qps "
        f"({cert_s * 1e3:.1f} ms per {n_q} queries, of which kernel B "
        f"{counts['count_gt_eq']} x {b_ms:.2f} ms = {b_share:.1%}); "
        f"exact tier {n_q / exact_s:.0f} qps; certified share {share:.6f}, "
        f"cert stats {stats}; byte-identical to the exact tier on all "
        f"{n_q} queries; launches {counts}; max_memory_allocated "
        f"{peak} bytes")
    onepass = phase_onepass(idx, qs, k, (enames, esims),
                            {"certified": n_q / cert_s,
                             "exact": n_q / exact_s}, d_ms)
    client.delete_index("flat-sift1m")
    return {name: c + onepass[name] for name, c in counts.items()}


def phase_onepass(idx, qs, k, exact_reply, qps, d_ms):
    """3c: the certified tier's default, one-pass form (kernel D) on
    flat-sift1m: byte-identical to the exact tier on every query,
    certified share >= 0.95 (two of a query's top 10 share one of 7,813
    bins with probability ~45/7813). Kernel D's share of the batch time
    is its launches per batch times ``d_ms``, its phase 1 time at this
    shape (2048 queries over 1,000,064 rows)."""
    from redis_hnsw_tpu_torch.ops import scan as S

    check(S.onepass_enabled(), "one-pass: not the certified tier's default")
    before = dict(S.CERT_STATS)
    reset_counts()
    t0 = time.perf_counter()
    onames, osims = idx.search_batch(qs, k, reply="columnar")
    first_s = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    onames2, osims2 = idx.search_batch(qs, k, reply="columnar")
    op_s = time.perf_counter() - t0
    check(counts["select_bins"] > 0 and counts["count_gt_eq"] == 0,
          f"one-pass: kernel D never launched, or kernel B did: {counts}")
    enames, esims = exact_reply
    for names, sims in ((onames, osims), (onames2, osims2)):
        check(np.array_equal(names, enames)
              and np.array_equal(sims.view(np.int32), esims.view(np.int32)),
              "one-pass: replies differ from the exact tier")
    stats = {key: S.CERT_STATS.get(key, 0) - before.get(key, 0)
             for key in ("batches", "queries", "fallback_queries",
                         "audits", "audit_mismatches")}
    share = 1.0 - stats["fallback_queries"] / stats["queries"]
    check(share >= 0.95, f"one-pass: certified share {share}")
    check(stats["audit_mismatches"] == 0, f"one-pass: audit {stats}")
    d_share = counts["select_bins"] * d_ms / (op_s * 1e3)
    log(f"phase 3c: flat-sift1m one-pass (the certified tier's default): "
        f"{len(qs)} queries byte-identical to the exact tier (two runs); "
        f"certified share {share:.6f}, cert stats {stats}; first call "
        f"{len(qs) / first_s:.0f} qps, then {len(qs) / op_s:.0f} qps "
        f"({op_s * 1e3:.1f} ms per {len(qs)} queries, of which kernel D "
        f"{counts['select_bins']} x {d_ms:.2f} ms = {d_share:.1%}), beside "
        f"two-pass certified {qps['certified']:.0f} qps and exact "
        f"{qps['exact']:.0f} qps; launches {counts}")
    return counts


# -- hamming (phases 2c and 3b) ---------------------------------------------

POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def hamming_dists(qs, rows_words):
    """Hamming distances (int64) of queries [B, W] to rows [B, ..., W]
    of uint32 words, by a byte table (numpy, independent of the port)."""
    q = qs.reshape(qs.shape[0], *([1] * (rows_words.ndim - 2)), -1)
    x = np.ascontiguousarray(np.bitwise_xor(q, rows_words))
    return POPCOUNT8[x.view(np.uint8)].sum(-1, dtype=np.int64)


def hamming_oracle(data, qs, k):
    """numpy brute force: per query the k rows nearest by hamming
    distance, ties to the lowest row; returns (rows [B, k], sims [B, k]
    = -distance as f32, -0.0 at distance 0, as the reply carries it)."""
    n = len(data)
    rows = np.empty((len(qs), k), np.int64)
    for lo in range(0, len(qs), 8):
        key = hamming_dists(qs[lo : lo + 8], data[None]) * n + np.arange(n)
        part = np.argpartition(key, k - 1, axis=1)[:, :k]
        rows[lo : lo + 8] = np.take_along_axis(
            part, np.argsort(np.take_along_axis(key, part, 1), axis=1), 1)
    return rows, -hamming_dists(qs, data[rows]).astype(np.float32)


def hamming_reply_check(rows, sims, names_of_row, names, rsims, label):
    """Replies equal the oracle's rows and sims byte for byte."""
    want = np.asarray(names_of_row, object)[rows]
    check(np.array_equal(names, want),
          f"{label}: reply names differ from the brute force")
    check(np.array_equal(rsims.view(np.int32), sims.view(np.int32)),
          f"{label}: reply sims differ from the brute force")


# config5's (ef, iters) sweep (bench.py:464-470)
HAMMING_SWEEP = ((256, 20), (320, 24), (400, 28), (512, 36))


def phase_hnsw_hamming(client, dev, n=10_000, n_q=2048):
    """2c: hnsw-hamming-256b, bench.py's config5. The scan route (kernel
    A′) against a numpy brute force byte for byte; the graph engine over
    config5's sweep until tie-aware recall@10 >= 0.95 (bench.py:143-159:
    a result counts if its sim reaches the oracle's k-th)."""
    W, k, name = 8, 10, "hnsw-hamming-256b"
    rng = np.random.default_rng(SEED + 4)
    data = rng.integers(0, 2**32, (n, W), dtype=np.uint32)
    qs = rng.integers(0, 2**32, (n_q, W), dtype=np.uint32)
    qs[0] = data[17]  # a distance-0 reply
    names = [f"h{i}" for i in range(n)]
    reset_counts()
    client.create_index(name, dim=32 * W, m=16, ef_construction=200,
                        seed=SEED, metric="hamming", backend="native")
    # config5 builds by add_batch (bench.py:496): the beam path, with the
    # wave's cross sims computed on the card
    build = bulk_build(client, name, names, data)
    check(build["refreshes"]["full"] == 1,
          f"{name}: the bulk build rebuilt its snapshot: {build}")
    t0 = time.perf_counter()
    snames, ssims = client.search_batch(name, qs, k=k, reply="columnar")
    first_s = time.perf_counter() - t0
    scan_s, (snames2, ssims2) = timed(
        lambda: client.search_batch(name, qs, k=k, reply="columnar"), 3)
    check(np.array_equal(snames, snames2)
          and np.array_equal(ssims.view(np.int32), ssims2.view(np.int32)),
          f"{name}: scan replies not repeatable")
    t0 = time.perf_counter()
    rows, osims = hamming_oracle(data, qs, k)
    oracle_s = time.perf_counter() - t0
    hamming_reply_check(rows, osims, names, snames, ssims, f"{name} scan")
    kth = osims[:, -1]
    row_of = {nm: i for i, nm in enumerate(names)}
    seen = []
    for ef, iters in HAMMING_SWEEP:
        gnames, gsims = client.search_batch(
            name, qs, k=k, engine="graph", ef_search=ef, iters=iters,
            expand=16, reply="columnar")
        grows = np.array([[row_of.get(x, -1) for x in row]
                          for row in gnames.tolist()])
        distinct = (np.diff(np.sort(grows, axis=1), axis=1) > 0).all()
        check(distinct and grows.min() >= 0,
              f"{name} graph: a reply is not {k} distinct names")
        true = -hamming_dists(qs, data[grows]).astype(np.float32)
        check(np.array_equal(gsims.view(np.int32), true.view(np.int32))
              and (np.diff(gsims, axis=1) <= 0).all(),
              f"{name} graph: sims wrong or not nearest first")
        recall = float((gsims >= kth[:, None]).sum()) / gsims.size
        seen.append((ef, iters, recall))
        if recall >= GRAPH_RECALL:
            break
    else:
        raise CheckFailed(f"{name}: no sweep point reaches tie-aware "
                          f"recall@{k} >= {GRAPH_RECALL}: {seen}")
    graph_s, _ = timed(lambda: client.search_batch(
        name, qs, k=k, engine="graph", ef_search=ef, iters=iters, expand=16,
        reply="columnar"), 2)
    counts = read_counts()
    check(counts["scan_topk_hamming"] > 0,
          f"{name}: kernel A′ never launched: {counts}")
    log(f"phase 2c: {name}: built {n} rows by add_batch(batch_size=2048) in "
        f"{build['s']:.3f} s ({n / build['s']:.1f} inserts/s; phases "
        f"{json.dumps(build['phases'])}; snapshot refreshes "
        f"{build['refreshes']}; build launches {build['launches']}); scan "
        f"search_batch {n_q} queries "
        f"k={k}: first call {first_s * 1e3:.1f} ms, then {n_q / scan_s:.0f} "
        f"qps columnar, byte-identical to a numpy brute force ({oracle_s:.1f}"
        f" s); graph engine (expand=16) sweep {seen}: chosen ef={ef} "
        f"iters={iters}, {n_q / graph_s:.0f} qps ({graph_s * 1e3:.1f} ms per "
        f"batch); launches {counts}")
    client.delete_index(name)
    return counts


def phase_hamming_lattice(dev, n=2000, n_q=256, devices=("cuda", "cpu")):
    """2c: a 2,000-row hamming index served on the card and on the CPU:
    graph replies equal byte for byte with the word blocks (forced with
    "f32") and with row gathers ("off"), expand 1 and 16, seeds 0 and 4;
    and the scan's."""
    import redis_hnsw_tpu_torch as h

    rng = np.random.default_rng(SEED + 7)
    data = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    data[1000:1008] = data[3]  # a tie class
    qs = rng.integers(0, 2**32, (n_q, 8), dtype=np.uint32)
    qs[0] = data[3]
    clients = [h.HNSW(device=d) for d in devices]
    for c in clients:
        c.create_index("hl", dim=256, m=8, ef_construction=64, seed=SEED,
                       metric="hamming")
        for i in range(n):
            c.add_node("hl", f"l{i}", data[i])
    checked = 0
    for j, tier in enumerate(("f32", "off")):
        os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"] = tier
        try:
            for c in clients:  # a mutation rebuilds the tier
                c.delete_node("hl", f"l{j * 7 + 1}")
            for kw in (dict(expand=1), dict(expand=16),
                       dict(expand=16, seeds=4), dict(expand=1, seeds=4),
                       dict(engine="scan")):
                kw = dict(dict(engine="graph"), **kw)
                got = [c.search_batch("hl", qs, k=10, reply="columnar", **kw)
                       for c in clients]
                check(np.array_equal(got[0][0], got[1][0])
                      and np.array_equal(got[0][1].view(np.int32),
                                         got[1][1].view(np.int32)),
                      f"hamming-lattice: card and CPU replies differ "
                      f"({tier}, {kw})")
                checked += 1
        finally:
            del os.environ["REDIS_HNSW_TPU_NBRVEC_DTYPE"]
    log(f"phase 2c: a {n}-row hamming index, {n_q} queries: card replies "
        f"equal the CPU's byte for byte in {checked} configurations (word "
        f"blocks / row gathers, expand 1/16, seeds 0/4, scan)")


def phase_flat_hamming(client, dev):
    """3b: flat-hamming-sift256 -- 1,000,000 x 256-bit rows, the shape of
    ann-benchmarks' sift-256-hamming (seeded random bits: no download),
    16,384 queries, k = 10, on the exact hamming tier (kernel A′), which
    a hamming table takes at every size and with SCAN_CERT=1 too."""
    from redis_hnsw_tpu_torch.ops import scan as S

    n, W, n_q, k, name = 1_000_000, 8, 16_384, 10, "flat-hamming-sift256"
    rng = np.random.default_rng(SEED + 8)
    data = rng.integers(0, 2**32, (n, W), dtype=np.uint32)
    qs = rng.integers(0, 2**32, (n_q, W), dtype=np.uint32)
    names = [f"b{i}" for i in range(n)]
    idx = client.create_index(name, dim=32 * W, kind="flat", metric="hamming")
    t0 = time.perf_counter()
    client.add_batch(name, names, data)
    add_s = time.perf_counter() - t0
    before = dict(S.CERT_STATS)
    reset_counts()
    t0 = time.perf_counter()
    enames, esims = idx.search_batch(qs, k, reply="columnar")
    first_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["scan_topk_hamming"] > 0,
          f"{name}: kernel A′ never launched: {counts}")
    exact_s, (enames2, esims2) = timed(
        lambda: idx.search_batch(qs, k, reply="columnar"), 1)
    os.environ["REDIS_HNSW_TPU_SCAN_CERT"] = "1"
    try:
        cnames, csims = idx.search_batch(qs, k, reply="columnar")
    finally:
        del os.environ["REDIS_HNSW_TPU_SCAN_CERT"]
    check(S.CERT_STATS == before,
          f"{name}: a hamming batch took the certified tier")
    pallas_s, (pnames, psims) = timed(
        lambda: idx.search_batch(qs, k, reply="columnar", use_pallas=True), 1)
    for label, (nm, sm) in (("a second run", (enames2, esims2)),
                            ("SCAN_CERT=1", (cnames, csims)),
                            ("use_pallas=True", (pnames, psims))):
        check(np.array_equal(enames, nm)
              and np.array_equal(esims.view(np.int32), sm.view(np.int32)),
              f"{name}: replies differ from {label}")
    sample = np.arange(0, n_q, n_q // 32)
    t0 = time.perf_counter()
    rows, osims = hamming_oracle(data, qs[sample], k)
    oracle_s = time.perf_counter() - t0
    hamming_reply_check(rows, osims, names, enames[sample], esims[sample],
                        name)
    log(f"phase 3b: {name}: add_batch {n} rows {add_s:.2f} s; search_batch "
        f"{n_q} queries k={k} exact tier: first call {first_s:.3f} s (table "
        f"upload), then {n_q / exact_s:.0f} qps; use_pallas "
        f"{n_q / pallas_s:.0f} qps; byte-identical to a second run, to "
        f"SCAN_CERT=1 and to use_pallas on all {n_q} queries, to a numpy "
        f"brute force on {len(sample)} ({oracle_s:.1f} s); launches {counts}")
    client.delete_index(name)
    return counts


def ptxas_figures(text: str, name: str) -> dict:
    """{entry function: its ptxas -v lines} for the entry functions whose
    mangled name holds ``name``."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function '" in line:
            cur = line.split("'")[1]
            cur = cur if name in cur else None
            if cur:
                out[cur] = []
        elif cur and ("spill" in line or "Used" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return out


def log_core_figures(path, kernel: str, smem_fn: str, slots: int) -> None:
    """One line: a split kernel's registers, spills and shared memory per
    form (<4>: 16-byte copies, <1>: 4-byte copies) and its resident
    blocks (kernels A, A′, B and D)."""
    import ctypes

    from redis_hnsw_tpu_torch.utils import build

    figs = ptxas_figures(build.build_log(path), kernel)
    smem = getattr(ctypes.CDLL(path), smem_fn)()
    forms = "; ".join(
        f"<{'4' if 'Li4E' in fn else '1'}> " + ", ".join(lines)
        for fn, lines in sorted(figs.items()))
    log(f"phase 0: {kernel}: {forms or 'no ptxas output'}; "
        f"{smem} bytes of dynamic shared memory a block; {slots} resident "
        f"blocks on the card")


def log_block_score_figures(path, card_index) -> None:
    """Kernel C's ptxas figures per instance, and its plans at the main
    shapes: warps, ring, shared memory a block and resident blocks."""
    import ctypes

    from redis_hnsw_tpu_torch.ops import cuda_gather
    from redis_hnsw_tpu_torch.utils import build

    figs = ptxas_figures(build.build_log(path), "block_score")
    log("phase 0: block_score_kernel (I<type>Li<form>: 1 block, 2 rows) and "
        "block_score_direct: " + "; ".join(
            f"{fn.split('block_score_')[-1][:40]} " + ", ".join(lines)
            for fn, lines in sorted(figs.items())))
    lib = ctypes.CDLL(path)
    sms = torch.cuda.get_device_properties(card_index).multi_processor_count
    plans = {}
    for label, (B, E, F, dt, elem) in {
            "f32 B=2048": (2048, 16, 32, 0, 4),
            "f16 B=2048": (2048, 16, 32, 1, 2),
            "f32 B=16": (16, 16, 32, 0, 4),
            "f32 rows J=512": (2048, 512, 1, 0, 4),
            "f16 rows J=512": (2048, 512, 1, 1, 2),
            "f32 rows J=16": (2048, 16, 1, 0, 4)}.items():
        p = cuda_gather.plan(sms, B, E, F, 128, elem, True)
        plans[label] = dict(
            p._asdict(), smem=lib.block_score_smem_bytes(
                p.form, 128, dt, p.warps, p.ring),
            resident=lib.block_score_slots(p.form, 128, dt, p.warps, p.ring))
    log(f"phase 0: block_score plans at D = 128 (form 1 block, 2 rows; "
        f"smem bytes a block; resident blocks on the card): "
        f"{json.dumps(plans)}")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--build-rows", type=int, default=0,
        help="run only phase 2d's bulk build and serving, at this many rows "
        "(e.g. 1000000, SIFT1M's size), and print its lines; the graph "
        "engine's recall is logged, not gated")
    args = parser.parse_args()
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
    if args.build_rows:
        counts, a_row = phase_build(h.HNSW(), dev, n=args.build_rows,
                                    gate=False)
        log(card)
        log(json.dumps({"build_rows": args.build_rows, "launches": counts,
                        "scan_topk_build_shape": a_row}))
        return 0
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_scan, cuda_select

    card_index = torch.cuda.current_device()
    log_core_figures(paths["scan_topk"], "scan_tile_kernel",
                     "scan_topk_smem_bytes", cuda_scan.block_slots(card_index))
    log_core_figures(paths["count_gt_eq"], "count_kernel",
                     "count_gt_eq_smem_bytes",
                     cuda_count.block_slots(card_index))
    log_core_figures(paths["scan_topk"], "hamming_tile_kernel",
                     "scan_topk_hamming_smem_bytes",
                     cuda_scan.hamming_block_slots(card_index))
    log_core_figures(paths["select_bins"], "select_bins_kernel",
                     "select_bins_smem_bytes",
                     cuda_select.block_slots(card_index))
    log_block_score_figures(paths["block_score"], card_index)

    kernels = phase_kernels(dev)
    kernels.update(phase_hamming_kernels(dev))
    kernels["block_score"] = phase_block_score(dev)
    kernels["select_bins"] = phase_select(dev)
    client = h.HNSW()
    launches, c_forms = phase_hnsw(client, dev)
    kernels["block_score"]["launches_by_form"] = c_forms
    path_counts = [phase_graph_lattice(dev), phase_hnsw_hamming(client, dev)]
    phase_hamming_lattice(dev)
    build_counts, kernels["scan_topk"]["build_shape"] = phase_build(client,
                                                                    dev)
    path_counts += [build_counts,
                    phase_flat(client, dev, kernels["count_gt_eq"]["ms"],
                               kernels["select_bins"]["ms"]),
                    phase_flat_hamming(client, dev)]
    for counts in path_counts:
        for name, c in counts.items():
            launches[name] += c
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} never launched on the main path")
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
