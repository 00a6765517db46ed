"""ctypes binding of the native host-side graph core (csrc/hnsw_core.cpp).

The same C ABI as ``redis_hnsw_tpu/native_core.py`` binds. The library is
compiled from the port's own copy of the JAX package's host core,
``redis_hnsw_tpu_torch/csrc/hnsw_core.cpp`` (the same code, so both
packages build byte-identical graphs), with ``g++ -O3 -std=c++17 -fPIC
-shared`` into ``build/native/`` (see utils/build.py). Nothing outside
this package is read or built. ``load()`` returns None when the
toolchain or source is missing; models/hnsw.py then raises for
``backend="native"`` and uses its pure-Python engine (identical
semantics) for ``"auto"``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .utils.build import CSRC_DIR, start_build

_SRC = os.path.join(CSRC_DIR, "hnsw_core.cpp")

_lock = threading.Lock()
_lib = None
_tried = False

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P = ctypes.c_void_p
    I = ctypes.c_int
    L = ctypes.c_long
    lib.hnsw_new.restype = P
    lib.hnsw_new.argtypes = [I, I, I, I, I, I]
    lib.hnsw_free.argtypes = [P]
    lib.hnsw_attach.argtypes = [P, ctypes.c_void_p, L]
    lib.hnsw_alloc_node.argtypes = [P, I, I]
    lib.hnsw_level.argtypes = [P, I]
    lib.hnsw_level.restype = I
    lib.hnsw_n_layers.argtypes = [P, I]
    lib.hnsw_n_layers.restype = I
    lib.hnsw_degree.argtypes = [P, I, I]
    lib.hnsw_degree.restype = I
    lib.hnsw_get_neighbors.argtypes = [P, I, I, _I32P, I]
    lib.hnsw_get_neighbors.restype = I
    lib.hnsw_set_neighbors.argtypes = [P, I, I, _I32P, I]
    lib.hnsw_insert.argtypes = [P, I, I, ctypes.c_void_p, I, I]
    lib.hnsw_delete.argtypes = [P, I]
    lib.hnsw_delete_batch.argtypes = [P, _I32P, I]
    lib.hnsw_search.argtypes = [
        P, ctypes.c_void_p, I, I, I, I, _I32P, _F32P,
    ]
    lib.hnsw_search.restype = I
    lib.hnsw_apply_wave.argtypes = [
        P, _I32P, _I32P, I, _I32P, _F32P, I, _I32P, _F32P, I, _F32P, I,
    ]
    lib.hnsw_max_degree.argtypes = [P, I, I]
    lib.hnsw_max_degree.restype = I
    lib.hnsw_export_layer.argtypes = [P, I, ctypes.c_void_p, I, I, _I32P]
    lib.hnsw_total_links.argtypes = [P, I]
    lib.hnsw_total_links.restype = L
    lib.hnsw_export_all.argtypes = [P, I, I, _I32P, _I32P]
    lib.hnsw_dirty_count.argtypes = [P]
    lib.hnsw_dirty_count.restype = L
    lib.hnsw_drain_dirty.argtypes = [P, _I32P]
    return lib


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native core; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        try:
            _, finish = start_build(
                "native", "libhnswcore", [_SRC], [],
                lambda out: [
                    "g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                    "-o", out, _SRC,
                ],
            )
            _lib = _bind(ctypes.CDLL(finish()))
        except (OSError, RuntimeError):
            # OSError: no g++ or an unloadable library; RuntimeError: the
            # compile failed. Either way the native backend is missing.
            _lib = None
        return _lib


class NativeGraph:
    """Owns one native Core; mirrors the narrow graph interface used by
    models/hnsw.py. The vector table is borrowed from the host index and
    must be re-attached after every growth (numpy realloc)."""

    def __init__(self, lib, m, m_max, m_max0, ef_construction, metric,
                 width) -> None:
        self._lib = lib
        self._h = lib.hnsw_new(
            m, m_max, m_max0, ef_construction,
            1 if metric == "hamming" else 0, width,
        )
        self._vecs = None  # keepalive for the borrowed pointer

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and self._h:
            lib.hnsw_free(self._h)
            self._h = None

    def attach(self, vectors: np.ndarray) -> None:
        if not vectors.flags["C_CONTIGUOUS"]:
            raise ValueError("native core needs a C-contiguous table")
        self._vecs = vectors  # keep the buffer alive
        self._lib.hnsw_attach(
            self._h, vectors.ctypes.data_as(ctypes.c_void_p),
            vectors.shape[0],
        )

    def alloc_node(self, row: int, level: int) -> None:
        self._lib.hnsw_alloc_node(self._h, row, level)

    def level(self, row: int) -> int:
        return self._lib.hnsw_level(self._h, row)

    def n_layers(self, row: int) -> int:
        return self._lib.hnsw_n_layers(self._h, row)

    def degree(self, row: int, lc: int) -> int:
        return self._lib.hnsw_degree(self._h, row, lc)

    def neighbors(self, row: int, lc: int) -> list[int]:
        deg = self._lib.hnsw_degree(self._h, row, lc)
        if deg == 0:
            return []
        out = np.empty(deg, np.int32)
        n = self._lib.hnsw_get_neighbors(self._h, row, lc, out, deg)
        return out[:n].tolist()

    def set_neighbors(self, row: int, lc: int, ids) -> None:
        arr = np.ascontiguousarray(ids, np.int32)
        self._lib.hnsw_set_neighbors(self._h, row, lc, arr, arr.size)

    def insert(self, row, level, q: np.ndarray, ep, l_max) -> None:
        self._lib.hnsw_insert(
            self._h, row, level, q.ctypes.data_as(ctypes.c_void_p),
            ep, l_max,
        )

    def delete(self, row: int) -> None:
        self._lib.hnsw_delete(self._h, row)

    def delete_batch(self, rows) -> None:
        arr = np.ascontiguousarray(rows, np.int32)
        self._lib.hnsw_delete_batch(self._h, arr, arr.size)

    def search(self, q: np.ndarray, k, ef, ep, l_max):
        cap = max(int(ef), int(k))
        ids = np.empty(cap, np.int32)
        sims = np.empty(cap, np.float32)
        n = self._lib.hnsw_search(
            self._h, q.ctypes.data_as(ctypes.c_void_p),
            min(int(k), cap), int(ef), int(ep), int(l_max), ids, sims,
        )
        return ids[:n], sims[:n]

    def apply_wave(self, rows, levels, up_ids, up_sims, l0_ids, l0_sims,
                   cross, l_max_snap) -> None:
        """Bulk-wave surgery (ops/construct.py ``complete_wave``): link W
        inserts in wave order from their candidate lists. ``up_ids`` /
        ``up_sims`` [n_up, W, C] hold layers 1..n_up, ``l0_*`` [W, C]
        layer 0, ``cross`` [W, W] the intra-wave sims."""
        rows = np.ascontiguousarray(rows, np.int32)
        levels = np.ascontiguousarray(levels, np.int32)
        W = rows.size
        up_ids = np.ascontiguousarray(up_ids, np.int32)
        l0_ids = np.ascontiguousarray(l0_ids, np.int32)
        cross = np.ascontiguousarray(cross, np.float32)
        C = l0_ids.shape[1]
        if (levels.size != W or l0_ids.shape[0] != W
                or up_ids.shape[1:] != (W, C) or cross.shape != (W, W)):
            raise ValueError("apply_wave: candidate arrays do not match "
                             f"the wave of {W} rows")
        # C names ef and n_up (csrc/hnsw_core.cpp apply_wave): ef is the
        # fetch width C of every candidate list, n_up the upper layers
        self._lib.hnsw_apply_wave(
            self._h, rows, levels, W,
            up_ids, np.ascontiguousarray(up_sims, np.float32),
            up_ids.shape[0],
            l0_ids, np.ascontiguousarray(l0_sims, np.float32), C,
            cross, int(l_max_snap),
        )

    def max_degree(self, lc: int, n: int) -> int:
        return self._lib.hnsw_max_degree(self._h, lc, n)

    def export_layer(self, lc: int, sel, n: int, deg: int) -> np.ndarray:
        out = np.empty((n, deg), np.int32)
        if sel is None:
            self._lib.hnsw_export_layer(self._h, lc, None, n, deg, out)
        else:
            sel = np.ascontiguousarray(sel, np.int32)
            self._lib.hnsw_export_layer(
                self._h, lc, sel.ctypes.data_as(ctypes.c_void_p), n,
                deg, out,
            )
        return out

    def drain_dirty(self) -> np.ndarray:
        """Rows whose adjacency changed since the last drain (clears)."""
        n = self._lib.hnsw_dirty_count(self._h)
        out = np.empty(max(n, 1), np.int32)
        if n:
            self._lib.hnsw_drain_dirty(self._h, out)
        return out[:n]

    def export_all(self, n: int, n_layers: int):
        total = self._lib.hnsw_total_links(self._h, n)
        counts = np.zeros((n, n_layers), np.int32)
        flat = np.empty(total, np.int32)
        self._lib.hnsw_export_all(self._h, n, n_layers, counts, flat)
        return counts, flat
