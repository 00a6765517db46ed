"""TEXMEX dataset loaders (fvecs / bvecs / ivecs).

Port of ``redis_hnsw_tpu/utils/datasets.py`` (numpy only, the same
bytes): a file written by either package reads back equal in the other.

SIFT1M / GIST1M / Deep1B artifacts ship in the TEXMEX vector format:
every row is a little-endian int32 dimension count followed by that many
values (f32 for .fvecs, uint8 for .bvecs, int32 for .ivecs ground-truth
id lists). The reference has no dataset tooling at all (its only
workload is the 100-node cmd.sh lattice); these loaders exist so the
BASELINE.json config-2/3 sweeps (SIFT1M/GIST1M recall@10-vs-QPS) run on
the real artifacts the moment a file path exists on the box --
``benchmarks/million.py sweep ... fvecs:<base.fvecs>:<query.fvecs>``.

No egress happens here: these read local files only.
"""

from __future__ import annotations

import os

import numpy as np


def _read_vecs(path: str, dtype, *, count: int = -1) -> np.ndarray:
    """Read a TEXMEX *vecs file into [n, dim].

    ``count`` limits the number of rows read (-1 = all). The row width
    is validated against the file size (every row must carry the same
    dimension header).
    """
    itemsize = np.dtype(dtype).itemsize
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype=np.int32, count=1)
        if head.size == 0:
            return np.empty((0, 0), dtype)
        dim = int(head[0])
        if dim <= 0 or dim > 1_000_000:
            raise ValueError(f"{path}: implausible dimension {dim}")
        row_bytes = 4 + dim * itemsize
        size = os.fstat(f.fileno()).st_size
        if size % row_bytes:
            raise ValueError(
                f"{path}: size {size} is not a multiple of the "
                f"{row_bytes}-byte row (dim {dim}, dtype {dtype})"
            )
        n = size // row_bytes
        if count >= 0:
            n = min(n, count)
        f.seek(0)
        raw = np.fromfile(f, dtype=np.uint8, count=n * row_bytes)
    rows = raw.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view(np.int32).ravel()
    if not (dims == dim).all():
        bad = int(np.argmax(dims != dim))
        raise ValueError(
            f"{path}: row {bad} has dimension {int(dims[bad])} != {dim}"
        )
    return rows[:, 4:].copy().view(dtype).reshape(n, dim)


def read_fvecs(path: str, count: int = -1) -> np.ndarray:
    """float32 vectors (SIFT/GIST base+query files)."""
    return _read_vecs(path, np.float32, count=count)


def read_bvecs(path: str, count: int = -1) -> np.ndarray:
    """uint8 vectors (Deep1B/ANN_SIFT1B style); returned as float32 so
    they drop straight into a euclidean index."""
    return _read_vecs(path, np.uint8, count=count).astype(np.float32)


def read_ivecs(path: str, count: int = -1) -> np.ndarray:
    """int32 id lists (TEXMEX ground-truth files)."""
    return _read_vecs(path, np.int32, count=count)


def write_fvecs(path: str, data: np.ndarray) -> None:
    """Write [n, dim] float32 rows in fvecs format (test fixtures)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, dim = data.shape
    out = np.empty((n, 1 + dim), dtype=np.int32)
    out[:, 0] = dim
    out[:, 1:] = data.view(np.int32)
    out.tofile(path)


def load_pair(spec: str, count: int = -1):
    """Parse ``fvecs:<base>:<query>`` / ``bvecs:<base>:<query>`` specs
    (the million.py dataset-kind grammar) into (base, queries)."""
    kind, _, rest = spec.partition(":")
    base_path, _, query_path = rest.partition(":")
    if not base_path or not query_path:
        raise ValueError(
            f"dataset spec {spec!r} must be {kind}:<base>:<query>"
        )
    reader = {"fvecs": read_fvecs, "bvecs": read_bvecs}[kind]
    return reader(base_path, count=count), reader(query_path)
