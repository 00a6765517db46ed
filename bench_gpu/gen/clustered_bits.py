"""Binary codes of the clustered stand-in: the sign bits of
``clustered.py``'s mixture, packed 32 to a word.

ann-benchmarks' ``sift-256-hamming`` holds 256-bit binary codes of
SIFT1M's vectors. Its files cannot be fetched, so this generator draws
``clustered.py``'s mixture (``centres`` centres N(0, 1), each vector a
uniformly chosen centre plus ``sigma`` N(0, 1) noise) at ``dim``
dimensions on the given device from the run's seed, and keeps one bit a
dimension, ``x > 0``: a SimHash-style code of clustered data. At
``sigma`` 0.8 and 256 bits, codes of one cluster lie ~86 bits apart and
codes of two clusters ~128, so a query's nearest codes lie in its own
cluster and ties at the k-th distance are common.

Bit j of word w is dimension 32 w + j. The words go to the host as
uint32, the client's format for a hamming index (``dim / 32`` words a
row); each block is packed on the device as it is drawn, so the host
holds only words. The checked query rows are drawn as ``clustered.py``
draws them. A configuration names this generator by ``"generator":
{"kind": "clustered_bits", ...}``.
"""

from __future__ import annotations

import numpy as np
import torch

from .clustered import QUERY_CHUNK, Inputs, _mixture, generator, seed_bits


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """[M, D] float -> [M, D / 32] int32 words of the bits ``x > 0``."""
    m, d = x.shape
    if d % 32:
        raise ValueError(f"{d} dimensions are not whole 32-bit words")
    bits = (x > 0).view(m, d // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=x.device) << (
        torch.arange(32, device=x.device))
    return (bits * weights).sum(-1).to(torch.int32)


def unpack_bits(words: np.ndarray) -> np.ndarray:
    """[M, W] uint32 words -> [M, 32 W] bool bits, :func:`pack_bits`'s
    order."""
    w = np.asarray(words, np.uint32)
    return ((w[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(
        w.shape[0], -1).astype(bool)


def _codes(g, centres, n: int, sigma: float) -> np.ndarray:
    """``n`` draws of the mixture as [n, D / 32] uint32 words on the host,
    drawn and packed on the device a block at a time."""
    out = np.empty((n, centres.shape[1] // 32), np.uint32)
    for lo in range(0, n, QUERY_CHUNK):
        m = min(QUERY_CHUNK, n - lo)
        words = pack_bits(_mixture(g, centres, m, sigma)[0])
        out[lo : lo + m] = words.cpu().numpy().view(np.uint32)
    return out


def make_inputs(config: dict, traffic: dict, seed: int, device,
                n_pool: int) -> Inputs:
    """Base codes, warm-up query codes, a query pool of ``n_pool``
    requests and the checked query rows of each request, all from
    ``seed``: uint32 words, ``dim / 32`` a row."""
    spec = config["generator"]
    if spec["kind"] != "clustered_bits":
        raise ValueError(f"unknown generator {spec['kind']!r}")
    if traffic["load_order"] != "generator":
        raise ValueError(f"unknown load order {traffic['load_order']!r}")
    n, dim = int(config["rows"]), int(config["dim"])
    b = int(traffic["request_queries"])
    n_warm = int(traffic["warmup_requests"])
    sigma = float(spec["sigma"])
    g = generator(seed, device)
    centres = torch.randn((int(spec["centres"]), dim), generator=g,
                          device=torch.device(device))
    rows = _codes(g, centres, n, sigma)
    queries = _codes(g, centres, (n_warm + n_pool) * b, sigma)
    rng = np.random.default_rng([seed_bits(seed), 1])
    k = int(traffic["check_per_request"])
    samples = np.stack([
        np.sort(rng.choice(b, size=k, replace=False)) for _ in range(n_pool)
    ]).astype(np.int64)
    return Inputs(rows=rows, warm=queries[: n_warm * b],
                  pool=queries[n_warm * b :], samples=samples)
