"""Drive redis_hnsw_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. It builds the CUDA kernels from
``redis_hnsw_tpu_torch/csrc`` into ``build/``, then:

0. prints the card's name and power limit and the kernels' build time;
1. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged edges: bitwise on integer-lattice
   data (every score exact in f32), to a stated tolerance on Gaussian
   data; times kernel, plain version and a library yardstick. Kernel C
   (block gather-score) is timed over a SIFT1M-size block table
   (1,000,064 rows x 32 neighbours x 128 dims, f16 and f32);
2. ``hnsw-main``: the reference workload -- an HNSW index of 10,000 x 128
   rows (M=16, efcon=200, native host core) served by ``search_batch``
   on the exact scan tier (kernel A) and on the graph engine (kernel C;
   the (ef, iters) sweep of bench.py up to recall@10 >= 0.95), before
   and after 100 deletes, and on the f16 and row-gather frontier tiers,
   checked against a float64 brute-force oracle;
2b. ``graph-lattice``: a 2,000-row integer-lattice HNSW index whose
   graph-engine replies on the card must equal the CPU's byte for byte;
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


def timed(fn, reps: int):
    """(host seconds per call, last result) over ``reps`` calls after
    one warm-up; each call ends in a host copy, so the clock covers the
    device work."""
    out = fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


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


def phase_block_score(dev, n=1_000_064, main_n=20_000):
    """Kernel C: ragged and main-shape checks, then times over a
    SIFT1M-size block table built by the snapshot's own _build_nbrvec."""
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
    rows = {}
    for dtype in (torch.float16, torch.float32):
        t0 = time.perf_counter()
        nbrvec, nbrsqn = _build_nbrvec(vecs, sq, adj0, dtype=dtype)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        case = (q, qn, nbrvec, nbrsqn, cand)
        err = max(err, compare_block(case, False, f"sift1m {dtype}"))
        ms = sync_ms(lambda: cuda_gather.fused_block_score(*case), 20)
        plain = sync_ms(lambda: cuda_gather.plain_block_score(*case), 3)
        nbytes = (B * E * F * D * nbrvec.element_size()   # blocks
                  + B * E * F * 4 * 2                     # nbrsqn, out
                  + B * D * 4 + B * 4 + B * E * 4)        # q, qn, cand
        bound, by = bound_ms(2.0 * B * E * F * D, nbytes)
        rows[str(dtype)[6:]] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                    bound_by=by)
        log(f"phase 1: kernel C over a {tuple(nbrvec.shape)} "
            f"{str(dtype)[6:]} table ({nbrvec.numel() * nbrvec.element_size()}"
            f" bytes, built in {build_s:.2f} s): {ms:.4f} ms per launch at "
            f"B={B} E={E}, bound {bound:.4f} ms ({by}), plain {plain:.3f} ms")
        del nbrvec, nbrsqn, case
        torch.cuda.empty_cache()
    del vecs, sq, adj0
    torch.cuda.empty_cache()
    f32, f16 = rows["float32"], rows["float16"]
    return dict(
        route="cuda", source="redis_hnsw_tpu_torch/csrc/block_score.cu",
        replaces="redis_hnsw_tpu/ops/pallas_gather.py:98",
        max_abs_err=err, ms=f32["ms"], plain_ms=f32["plain_ms"],
        bound_ms=f32["bound_ms"], bound_by=f32["bound_by"], library_ms=None,
        ms_f16=f16["ms"], plain_ms_f16=f16["plain_ms"],
        bound_ms_f16=f16["bound_ms"],
        shape=dict(B=B, E=E, F=F, D=D, N=n),
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


def reset_counts():
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_gather, cuda_scan

    cuda_scan.flat_topk.launches = 0
    cuda_count.count_gt_eq.launches = 0
    cuda_gather.fused_block_score.launches = 0


def read_counts():
    from redis_hnsw_tpu_torch.ops import cuda_count, cuda_gather, cuda_scan

    return {"scan_topk": cuda_scan.flat_topk.launches,
            "count_gt_eq": cuda_count.count_gt_eq.launches,
            "block_score": cuda_gather.fused_block_score.launches}


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
    check(counts["scan_topk"] > 0, "hnsw-main: kernel A never launched")
    check(counts["block_score"] > 0, "hnsw-main: kernel C never launched")
    del xs64
    log(f"phase 2: hnsw-main: built {n} rows by add_node in {build_s:.2f} s "
        f"({n / build_s:.0f} inserts/s); scan search_batch {n_q} queries "
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
        f"recall, qps: {tiers}; launches {counts}")
    client.delete_index("hnsw-main")
    return counts


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
    kernels["block_score"] = phase_block_score(dev)
    client = h.HNSW()
    launches = phase_hnsw(client, dev)
    phase_graph_lattice(dev)
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
