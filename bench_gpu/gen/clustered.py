"""The clustered stand-in for ann-benchmarks' base and query sets.

A copy of the repository's clustered generator (``benchmarks/million.py``
``dataset`` / ``query_set``: ``centres`` centres drawn N(0, 1), each
vector a uniformly chosen centre plus ``sigma`` N(0, 1) noise, the
queries fresh draws of the same mixture), with the run's seed as its
argument. It draws on the given device from one ``torch.Generator`` in a
few large calls, so the same seed gives the same inputs on one device
type, and hands every array to the caller on the host, as a client holds
its vectors.

A configuration names this generator by ``"generator": {"kind":
"clustered", ...}``; another generator is a file of its own beside this
one with the same ``make_inputs``. The traffic mix picks the load order: ``generator`` keeps the draw order
(rows in random cluster order), ``cluster`` stable-sorts the rows by
centre (similar vectors side by side, YCSB's ``insertorder=ordered``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# queries drawn a call: bounds the card's temporaries at 1 GiB for 960 dims
QUERY_CHUNK = 1 << 18


@dataclass
class Inputs:
    rows: np.ndarray      # [n, dim] float32, in load order
    warm: np.ndarray      # [warmup_requests * B, dim] float32
    pool: np.ndarray      # [pool_requests * B, dim] float32
    samples: np.ndarray   # [pool_requests, check_per_request] int64
    #                       the query rows of each request that are checked


def seed_bits(seed: int) -> int:
    """The run's seed as the 64-bit value both generators take."""
    return int(seed) % (1 << 64)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed_bits(seed))
    return g


def _mixture(g, centres, n: int, sigma: float):
    pick = torch.randint(0, centres.shape[0], (n,), generator=g,
                         device=centres.device)
    x = torch.randn((n, centres.shape[1]), generator=g,
                    device=centres.device)
    return x.mul_(sigma).add_(centres[pick]), pick


def make_inputs(config: dict, traffic: dict, seed: int, device,
                n_pool: int) -> Inputs:
    """Base rows, warm-up queries, a query pool of ``n_pool`` requests and
    the checked query rows of each request, all from ``seed``."""
    spec = config["generator"]
    if spec["kind"] != "clustered":
        raise ValueError(f"unknown generator {spec['kind']!r}")
    n, dim = int(config["rows"]), int(config["dim"])
    b = int(traffic["request_queries"])
    n_warm = int(traffic["warmup_requests"])
    g = generator(seed, device)
    centres = torch.randn((int(spec["centres"]), dim), generator=g,
                          device=torch.device(device))
    rows, pick = _mixture(g, centres, n, float(spec["sigma"]))
    order = traffic["load_order"]
    if order == "cluster":
        rows = rows[torch.sort(pick, stable=True).indices]
    elif order != "generator":
        raise ValueError(f"unknown load order {order!r}")
    rows_host = rows.cpu().numpy()
    del rows, pick
    total = (n_warm + n_pool) * b
    queries = torch.empty((total, dim), dtype=torch.float32)
    for lo in range(0, total, QUERY_CHUNK):
        m = min(QUERY_CHUNK, total - lo)
        queries[lo : lo + m].copy_(
            _mixture(g, centres, m, float(spec["sigma"]))[0]
        )
    queries = queries.numpy()
    rng = np.random.default_rng([seed_bits(seed), 1])
    m = int(traffic["check_per_request"])
    samples = np.stack([
        np.sort(rng.choice(b, size=m, replace=False)) for _ in range(n_pool)
    ]).astype(np.int64)
    return Inputs(rows=rows_host, warm=queries[: n_warm * b],
                  pool=queries[n_warm * b :], samples=samples)
