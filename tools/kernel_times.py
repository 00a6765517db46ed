"""Time every CUDA kernel of a checkout of redis_hnsw_tpu_torch at the
main path's shapes, on one card, and print one JSON line.

    python3 tools/kernel_times.py [--root DIR] [--label NAME]
    python3 tools/kernel_times.py --a-splits 16,33,66


``--root`` is the checkout whose package (and kernel sources) is timed,
this one by default; it builds its kernels into ``DIR/build``. To compare
two trees on one card, run them in turns on one machine (parent, change,
change, parent), e.g. with the parent unpacked by ``git archive`` into a
directory that .gitignore lists.

Shapes: kernels A, B and D at B = 2048 queries over 1,000,064 rows of
D = 128 (A at k = 10 and k_sel = 40; A at k = 10 and B also at B = 16
over those rows and at hnsw-main's 2048 x 16,384; the bf16 and int8
tiers' kernels A-bf16 and A-int8 on those rows' bf16 and int8 copies, at
k = 10 and k = 80, the int8-resident tier's width: ``a_bf16_ms``,
``a_bf16_k80_ms``, ``a_int8_ms``, ``a_int8_k80_ms``, where the checkout
has them (``a_bf16_k80_ms`` where A-bf16 has forms); each core's general
form forced, ``a_int8_general_ms``, ``a_int8_general_k80_ms``,
``a_bf16_general_ms`` and ``a_bf16_general_k80_ms``, where it has
forms); A′ at 2048 x 1,000,064 rows of
8 words, k_sel = 40 and k = 10, at B = 16 over those rows and at 2048 x
16,384 (hnsw-hamming-256b's scan), k = 10; B′ (the certified hamming
tier's count) at t = the 10th of A′'s k_sel = 40 over those rows of 8
words (``b_hamming_ms``, the SM clock read after it ran), at B = 16
(``b_hamming_b16_ms``), over the first 16,384 rows, and at 2048 x
1,000,064 rows of 16 and 32 words (``b_hamming_w16_ms``,
``b_hamming_w32_ms``), where the checkout has B′; C at B = 2048, E = 16 over a
1,000,064 x 32 x 128 block table in f32 (``c_ms``), f16 and bf16, at B =
16 (f32 and f16), and in its row form over the table's first 1,000,064
rows at B = 2048 with J = 512 (f32 and f16) and J = 16 rows a lane
(``c_rows512_ms``, ``c_rows16_ms``), and at J = 512 with every other id
row 0 (``c_rows512_hot_ms``: the beam clamps masked slots to row 0); C's
B = 16 and J = 16 shapes are timed as CUDA graphs of 50 launches (a
launch's host cost exceeds those kernels'). Plus the yardstick torch.mm +
torch.topk at k = 40 and the card's SM clock while A ran. Times are
means of CUDA-event windows after a warm-up; data come from fixed seeds.

``--a-splits`` times only kernel A at B = 2048 over 1,000,064 rows (k =
10 and 40) with its row splits forced to each count given (a study of
kernel A's split planner; the kernel's results do not depend on it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch


def sync_ms(fn, reps: int) -> float:
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
    CUDA graph: at kernel C's small shapes a launch's host cost exceeds
    the kernel's, and event timing of a host loop measures the host."""
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


def count_hamming_of():
    """The checkout's kernel B′ module (ops/cuda_count_hamming.py), or
    None where it has none."""
    try:
        from redis_hnsw_tpu_torch.ops import cuda_count_hamming
    except ImportError:
        return None
    return cuda_count_hamming


def count_hamming_times(qw, xw, bias, shapes=True) -> dict:
    """Kernel B′ at t = the 10th of kernel A′'s k_sel = 40 (the certified
    hamming tier's call) over these words, the SM clock read right after;
    with ``shapes``, also at B = 16 and over the first 16,384 rows."""
    from redis_hnsw_tpu_torch.ops import cuda_count_hamming as H
    from redis_hnsw_tpu_torch.ops import cuda_scan

    t = cuda_scan.flat_topk_hamming(qw, xw, bias, k=40)[1][:, 9].contiguous()
    out = {"b_hamming_ms": sync_ms(
        lambda: H.count_hamming(qw, xw, bias, t), 20)}
    out["b_hamming_clock"] = smi("clocks.sm")
    if shapes:
        q16, t16 = qw[:16].contiguous(), t[:16].contiguous()
        out["b_hamming_b16_ms"] = sync_ms(
            lambda: H.count_hamming(q16, xw, bias, t16), 20)
        xs, bs = xw[:16_384], bias[:16_384]
        ts = cuda_scan.flat_topk_hamming(qw, xs, bs, k=40)[1][:, 9]
        ts = ts.contiguous()
        out["b_hamming_hnsw_ms"] = sync_ms(
            lambda: H.count_hamming(qw, xs, bs, ts), 20)
    return out


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--a-splits", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.root))
    from redis_hnsw_tpu_torch.ops import (
        cuda_count,
        cuda_gather,
        cuda_scan,
        cuda_select,
    )
    from redis_hnsw_tpu_torch.ops import distance as Dm
    from redis_hnsw_tpu_torch.utils import build

    assert os.path.abspath(build.REPO_ROOT) == os.path.abspath(args.root)
    build.build_kernels()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B, N, D = 2048, 1_000_064, 128
    x = torch.randn((N, D), generator=g, device=dev)
    q = torch.randn((B, D), generator=g, device=dev)
    sq, qq = Dm.sqnorms(x), Dm.sqnorms(q)
    t = {}
    if args.a_splits:
        planned = cuda_scan.plan(dev, B, N)
        want = cuda_scan.flat_topk(q, x, sq, qq, k=40)
        for s in map(int, args.a_splits.split(",")):
            tiles = -(-N // cuda_scan.TILE)
            cuda_scan.plan = lambda *a, s=s: (s, -(-tiles // s))
            got = cuda_scan.flat_topk(q, x, sq, qq, k=40)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            for k in (10, 40):
                t[f"a{k}_splits{s}_ms"] = sync_ms(
                    lambda: cuda_scan.flat_topk(q, x, sq, qq, k=k), 10)
        print(json.dumps({"label": args.label, "planned": planned,
                          "card": smi("name,power.limit"), **t}))
        return 0
    t["a_ms"] = sync_ms(lambda: cuda_scan.flat_topk(q, x, sq, qq, k=40), 10)
    t["a_clock"] = smi("clocks.sm")
    t["a10_ms"] = sync_ms(lambda: cuda_scan.flat_topk(q, x, sq, qq, k=10),
                          10)
    t["lib_ms"] = sync_ms(lambda: torch.topk(torch.mm(q, x.t()), 40, dim=1),
                          5)
    q16, qq16 = q[:16].contiguous(), qq[:16].contiguous()
    t["a_b16_ms"] = sync_ms(
        lambda: cuda_scan.flat_topk(q16, x, sq, qq16, k=10), 20)
    xs, sqs = x[:16_384], sq[:16_384]
    t["a_hnsw_ms"] = sync_ms(
        lambda: cuda_scan.flat_topk(q, xs, sqs, qq, k=10), 20)
    tt = cuda_scan.flat_topk(q, x, sq, qq, k=40)[1][:, 9].contiguous()
    tt16 = tt[:16].contiguous()
    t["b_ms"] = sync_ms(lambda: cuda_count.count_gt_eq(x, sq, q, qq, tt), 10)
    t["b_b16_ms"] = sync_ms(
        lambda: cuda_count.count_gt_eq(x, sq, q16, qq16, tt16), 20)
    t["b_hnsw_ms"] = sync_ms(
        lambda: cuda_count.count_gt_eq(xs, sqs, q, qq, tt), 20)
    t["d_ms"] = sync_ms(lambda: cuda_select.select_bins(x, sq, q, qq), 10)
    del xs, sqs, q16, qq16, tt, tt16
    if hasattr(cuda_scan, "flat_topk_int8"):  # a checkout with the tiers
        from redis_hnsw_tpu_torch.ops import scan as S

        xb, qb = S._to_bf16(x), S._to_bf16(q)
        t["a_bf16_ms"] = sync_ms(
            lambda: cuda_scan.flat_topk_bf16(qb, xb, sq, qq, k=10), 10)
        if hasattr(cuda_scan, "bf16_form"):  # a checkout with its forms
            t["a_bf16_k80_ms"] = sync_ms(
                lambda: cuda_scan.flat_topk_bf16(qb, xb, sq, qq, k=80), 10)
            for k in (10, 80):
                t["a_bf16_general_ms" if k == 10
                  else "a_bf16_general_k80_ms"] = sync_ms(
                    lambda: cuda_scan.flat_topk_bf16(qb, xb, sq, qq, k=k,
                                                     form="general"), 10)
        del xb, qb
        (x8, xs8), (q8, qs8) = S._to_int8(x), S._to_int8(q)
        for k in (10, 80):
            t["a_int8_ms" if k == 10 else "a_int8_k80_ms"] = sync_ms(
                lambda: cuda_scan.flat_topk_int8(q8, qs8, x8, xs8, sq, qq,
                                                 k=k), 10)
        if hasattr(cuda_scan, "int8_form"):  # a checkout with its forms
            for k in (10, 80):
                t["a_int8_general_ms" if k == 10
                  else "a_int8_general_k80_ms"] = sync_ms(
                    lambda: cuda_scan.flat_topk_int8(
                        q8, qs8, x8, xs8, sq, qq, k=k, form="general"), 10)
        del x8, xs8, q8, qs8
    del x, q, sq, qq
    torch.cuda.empty_cache()

    W = 8
    xw = torch.randint(-2**31, 2**31 - 1, (N, W), generator=g, device=dev,
                       dtype=torch.int32)
    qw = torch.randint(-2**31, 2**31 - 1, (B, W), generator=g, device=dev,
                       dtype=torch.int32)
    bias = torch.zeros(N, device=dev)
    t["a_hamming_ms"] = sync_ms(
        lambda: cuda_scan.flat_topk_hamming(qw, xw, bias, k=40), 10)
    t["a_hamming10_ms"] = sync_ms(
        lambda: cuda_scan.flat_topk_hamming(qw, xw, bias, k=10), 10)
    qw16 = qw[:16].contiguous()
    t["a_hamming_b16_ms"] = sync_ms(
        lambda: cuda_scan.flat_topk_hamming(qw16, xw, bias, k=10), 20)
    xws, biass = xw[:16_384], bias[:16_384]
    t["a_hamming_hnsw_ms"] = sync_ms(
        lambda: cuda_scan.flat_topk_hamming(qw, xws, biass, k=10), 20)
    has_b = count_hamming_of() is not None
    if has_b:
        t.update(count_hamming_times(qw, xw, bias))
    del xw, qw, bias, qw16, xws, biass
    torch.cuda.empty_cache()
    if has_b:
        for w in (16, 32):
            xw = torch.randint(-2**31, 2**31 - 1, (N, w), generator=g,
                               device=dev, dtype=torch.int32)
            qw = torch.randint(-2**31, 2**31 - 1, (B, w), generator=g,
                               device=dev, dtype=torch.int32)
            bias = torch.zeros(N, device=dev)
            t[f"b_hamming_w{w}_ms"] = count_hamming_times(
                qw, xw, bias, shapes=False)["b_hamming_ms"]
            del xw, qw, bias
            torch.cuda.empty_cache()

    E, F = 16, 32
    nbrvec = torch.randn((N, F, D), generator=g, device=dev)
    nbrsqn = Dm.sqnorms(nbrvec)
    qc = torch.randn((B, D), generator=g, device=dev)
    qn = Dm.sqnorms(qc)
    cand = torch.randint(0, N, (B, E), generator=g, device=dev,
                         dtype=torch.int32)
    t["c_ms"] = sync_ms(lambda: cuda_gather.fused_block_score(
        qc, qn, nbrvec, nbrsqn, cand), 20)
    c16 = cand[:16].contiguous()
    q16, qn16 = qc[:16].contiguous(), qn[:16].contiguous()
    t["c_b16_ms"] = graph_ms(lambda: cuda_gather.fused_block_score(
        q16, qn16, nbrvec, nbrsqn, c16), 50)
    # the row form over the table's first N rows: J = 512 (the off tier's
    # frontier) and J = 16 (a descent step)
    rows, rsq = nbrvec.view(N * F, D)[:N], nbrsqn.view(N * F)[:N]
    ids = torch.randint(0, N, (B, 512), generator=g, device=dev,
                        dtype=torch.int32)
    ids16 = ids[:, :16].contiguous()
    t["c_rows512_ms"] = sync_ms(lambda: cuda_gather.fused_row_score(
        qc, qn, rows, rsq, ids), 20)
    t["c_rows16_ms"] = graph_ms(lambda: cuda_gather.fused_row_score(
        qc, qn, rows, rsq, ids16), 50)
    hot = ids.clone()
    hot[:, 1::2] = 0  # masked slots, clamped to row 0 as the beam does
    t["c_rows512_hot_ms"] = sync_ms(lambda: cuda_gather.fused_row_score(
        qc, qn, rows, rsq, hot), 20)
    for name, dtype in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        nv = nbrvec.to(dtype)
        t[f"c_{name}_ms"] = sync_ms(lambda: cuda_gather.fused_block_score(
            qc, qn, nv, nbrsqn, cand), 20)
        if name == "f16":
            t["c_f16_b16_ms"] = graph_ms(
                lambda: cuda_gather.fused_block_score(q16, qn16, nv, nbrsqn,
                                                      c16), 50)
            nrows = nv.view(N * F, D)[:N]
            t["c_f16_rows512_ms"] = sync_ms(
                lambda: cuda_gather.fused_row_score(qc, qn, nrows, rsq, ids),
                20)
        del nv
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "root": args.root,
                      "card": smi("name,power.limit"), **t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
