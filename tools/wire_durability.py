"""Run chip_smoke.py's phase 4 (the wire and durability) alone.

    python3 tools/wire_durability.py [--stage-rows 16384] [--overlap-rows 4096]

From the root of a checkout, on a machine with one CUDA card: builds the
kernels, the two indexes phase 4 reads (hnsw-main, 10,000 x 128 rows by
``add_batch``; flat-sift1m, 1,000,000 x 128 rows), then runs phase 4
with the stream cut to ``--stage-rows`` a stage, and prints its lines.
A quick check of phase 4 before a full ``chip_smoke.py`` run.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import redis_hnsw_tpu_torch as h  # noqa: E402
from redis_hnsw_tpu_torch.utils import build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage-rows", type=int, default=16_384)
    ap.add_argument("--overlap-rows", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wire_durability: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    build.build_kernels()
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    client = h.HNSW()
    rng = np.random.default_rng(cs.SEED)
    client.create_index("hnsw-main", dim=128, m=16, ef_construction=200,
                        seed=cs.SEED)
    client.add_batch("hnsw-main", [f"v{i}" for i in range(10_000)],
                     rng.standard_normal((10_000, 128), dtype=np.float32),
                     batch_size=2048)
    client.create_index("flat-sift1m", dim=128, kind="flat")
    client.add_batch("flat-sift1m", [f"s{i}" for i in range(1_000_000)],
                     rng.standard_normal((1_000_000, 128), dtype=np.float32))
    cs.phase_wire_durability(client, torch.device("cuda"),
                             stage=args.stage_rows,
                             overlap_rows=args.overlap_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
