"""Kernel B′ (csrc/count_hamming.cu, the certified hamming tier's count)
under study builds of its knobs, timed in turns on one card at the
certified tier's call: B = 2048 queries over 1,000,064 rows of 8 words,
t = the 10th of kernel A′'s k_sel = 40.

    python3 tools/count_hamming_study.py [--reps 20]

Each variant is the kernel's source compiled by nvcc with its -D flags
(``RHT_HC_STAGES``: each warp's ring depth; ``RHT_HC_ROWS``: rows a
stage; ``RHT_HC_MINB``: resident blocks an SM asked of ptxas;
``RHT_HC_UNROLL``: n8 tiles unrolled together;
``RHT_HC_PART``: the parts of a stage that run, see the kernel's source
-- those variants count wrongly and are timed only) into
``build/study/`` and launched through its C interface on the same
operands, with its own resident blocks planned as the port plans
them. The variants that keep the function are held bitwise against the
shipped build. Prints one line a variant (ms, ptxas registers and
spills, resident blocks) and the card's name, power limit and SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "shipped": [],
    "stages4": ["-DRHT_HC_STAGES=4"],
    "minb3": ["-DRHT_HC_MINB=3"],
    "unroll2": ["-DRHT_HC_UNROLL=2"],
    "unroll8": ["-DRHT_HC_UNROLL=8"],
    "rows128_unroll4": ["-DRHT_HC_ROWS=128"],
    "rows32": ["-DRHT_HC_ROWS=32"],
    "products_only": ["-DRHT_HC_PART=1"],
    "no_popcounts": ["-DRHT_HC_PART=3"],
    "start_from_zero": ["-DRHT_HC_PART=4"],
    "no_filter_check": ["-DRHT_HC_PART=5"],
}
EXACT = ("shipped", "stages4", "minb3", "unroll2", "unroll8",
         "rows128_unroll4", "rows32")


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


def build_variants() -> dict:
    """{variant: (library path, ptxas lines)}, one nvcc each, all at once."""
    from redis_hnsw_tpu_torch.utils import build

    src = os.path.join(build.CSRC_DIR, "count_hamming.cu")
    headers = sorted(os.path.join(build.CSRC_DIR, f)
                     for f in os.listdir(build.CSRC_DIR) if f.endswith(".cuh"))
    nvcc = build.nvcc_path()
    started = {
        name: build.start_build(
            "study", f"libcount_hamming_{name}", [src], headers,
            lambda out, flags=flags: [nvcc, *build.NVCC_FLAGS, *flags, "-o",
                                      out, src])[1]
        for name, flags in VARIANTS.items()
    }
    out = {}
    for name, finish in started.items():
        path = finish()
        lines = [ln.split(":", 1)[-1].strip()
                 for ln in build.build_log(path).splitlines()
                 if "spill" in ln or "Used" in ln]
        out[name] = (path, lines)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("count_hamming_study: no CUDA device", file=sys.stderr)
        return 2
    from redis_hnsw_tpu_torch.ops import cuda_scan
    from redis_hnsw_tpu_torch.ops.cuda_select import plan_splits

    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B, N, W = 2048, 1_000_064, 8
    xw = torch.randint(-2**31, 2**31 - 1, (N, W), generator=g, device=dev,
                       dtype=torch.int32)
    qw = torch.randint(-2**31, 2**31 - 1, (B, W), generator=g, device=dev,
                       dtype=torch.int32)
    bias = torch.zeros(N, device=dev)
    t = cuda_scan.flat_topk_hamming(qw, xw, bias, k=40)[1][:, 9].contiguous()
    c_gt = torch.zeros(B, dtype=torch.int32, device=dev)
    c_eq = torch.zeros(B, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    rows, want = [], None
    for name in VARIANTS:
        path, lines = libs[name]
        lib = ctypes.CDLL(path)
        lib.count_hamming_launch.restype = I
        lib.count_hamming_launch.argtypes = [P, P, P, P, I, I, I, I, P, P, P]
        lib.count_hamming_slots.restype = I
        lib.count_hamming_slots.argtypes = [I]
        slots = lib.count_hamming_slots(W)
        tiles = -(-N // 128)
        splits = plan_splits(slots, -(-B // 128), tiles)

        def run():
            err = lib.count_hamming_launch(
                qw.data_ptr(), xw.data_ptr(), bias.data_ptr(), t.data_ptr(),
                B, N, W, splits, c_gt.data_ptr(), c_eq.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        c_gt.zero_()
        c_eq.zero_()
        run()
        torch.cuda.synchronize()
        got = (c_gt.clone(), c_eq.clone())
        if name == "shipped":
            want = got
        same = None
        if name in EXACT:
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        row = {"variant": name, "ms": sync_ms(run, args.reps),
               "bitwise_as_shipped": same, "slots": slots, "splits": splits,
               "ptxas": lines}
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}))
    return 0 if all(r["bitwise_as_shipped"] in (None, True)
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
