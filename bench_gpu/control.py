"""The control of the comparison that decides ``correct``.

    python3 -m bench_gpu.control --workload <cell> --seeds 11,12,13 --requests R

For each seed, makes the cell's inputs as a run does, puts the plain
reference computed in TF32 (``reference/<metric>.py``, one precision
below the float32 that the configurations state) in the program's place
for the checked answers of the window's first ``R`` requests, and judges
them with the run's own comparison and limits. One JSON line a seed:
the numbers, their limits and whether the control came out correct (it
has to come out not correct). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import spec
from .run import check_answers, make_inputs, pin_caches


def control_answers(inputs, metric: str, n_requests: int, k: int, b: int,
                    device, precision: str = "tf32"):
    """The checked answers of the first ``n_requests`` requests, as the
    reference of ``metric`` at ``precision`` gives them: (pool request,
    ids, sims, bad) each, as the run takes them from the program."""
    import importlib

    import numpy as np
    import torch

    ref = importlib.import_module(spec.part("reference", metric))

    n_pool = len(inputs.samples)
    reqs = [r % n_pool for r in range(n_requests)]
    qidx = np.concatenate([pr * b + inputs.samples[pr] for pr in reqs])
    rows = torch.from_numpy(inputs.rows).to(device)
    qs = torch.from_numpy(inputs.pool[qidx]).to(device)
    idx, dist = ref.knn(rows, qs, k, precision)
    ids = idx.cpu().numpy()
    sims = ref.similarity(dist.double().cpu().numpy())
    m = inputs.samples.shape[1]
    return [(pr, ids[i * m : (i + 1) * m], sims[i * m : (i + 1) * m],
             np.zeros(m, bool)) for i, pr in enumerate(reqs)]


def run_control(cell, seed: int, n_requests: int, device,
                precision: str = "tf32") -> dict:
    from .reference import compare

    cfg, mix = cell.config, cell.traffic
    n, k, b = int(cfg["rows"]), int(mix["k"]), int(mix["request_queries"])
    inputs = make_inputs(cell, seed, device, n_requests)
    taken = control_answers(inputs, cfg["metric"], n_requests, k, b, device,
                            precision)
    values = check_answers(inputs, taken, cfg["metric"], n, k, b, device)
    ok, checks = compare.judge(values, cfg["limits"])
    return {"cell": cell.name, "seed": seed, "control": precision,
            "requests": n_requests, "checks": checks, "correct": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, required=True)
    args = p.parse_args(argv)
    pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("bench_gpu.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_control(cell, seed, args.requests, "cuda")
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
