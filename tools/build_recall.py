"""Build one set of rows both ways, by add_batch and by add_node, and serve
both graphs the same queries on the graph engine; print one JSON line.

    python3 tools/build_recall.py [--rows 65536] [--queries 2048]

Rows and queries are seeded Gaussian 128-d vectors (phase 2d of
chip_smoke.py draws the same kind), M=16, efcon=200, native host core,
``add_batch(batch_size=2048)``. For each graph: its build seconds and
inserts/s, then recall@10 against a float64 oracle computed on the card
(chip_smoke.py ``ChunkedOracle``) and qps at each (ef_search, iters) of
chip_smoke.py's BUILD_SERVE_POINTS, expand = 16. It tells a build's
graph from its data: where the two graphs reach the same recall, the
data, not bulk construction, sets it. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import redis_hnsw_tpu_torch as h  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=65_536)
    parser.add_argument("--queries", type=int, default=2048)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("build_recall: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    n, dim, k = args.rows, 128, 10
    rng = np.random.default_rng(cs.SEED + 9)
    data = rng.standard_normal((n, dim), dtype=np.float32)
    qs = rng.standard_normal((args.queries, dim), dtype=np.float32)
    names = [f"b{i}" for i in range(n)]
    client = h.HNSW()
    out = {"card": cs.card_line(), "rows": n, "queries": len(qs)}
    for how in ("add_batch", "add_node"):
        client.create_index(how, dim=dim, m=16, ef_construction=200,
                            seed=cs.SEED, backend="native")
        t0 = time.perf_counter()
        if how == "add_batch":
            client.add_batch(how, names, data, batch_size=2048)
        else:
            for i in range(n):
                client.add_node(how, names[i], data[i])
        secs = time.perf_counter() - t0
        out[how] = {"s": secs, "inserts_per_s": n / secs, "points": []}
    xs64 = torch.from_numpy(data).to("cuda", torch.float64)
    oracle = cs.ChunkedOracle(xs64, qs, k)
    row_of = {nm: i for i, nm in enumerate(names)}
    for how in ("add_batch", "add_node"):
        for ef, iters in cs.BUILD_SERVE_POINTS:
            g_s, reply = cs.timed(lambda: client.search_batch(
                how, qs, k=k, engine="graph", ef_search=ef, iters=iters,
                expand=16, reply="columnar"), 1)
            r, _, short = oracle.recall(row_of, *reply, f"{how} ef={ef}")
            out[how]["points"].append(
                {"ef": ef, "iters": iters, "recall": r, "qps": len(qs) / g_s,
                 "short_replies": short})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
