"""Host API -- the command surface.

Port of ``redis_hnsw_tpu/api.py``: the seven ``HNSW.*`` commands of the
reference's Redis module (zhao-lang/redis_hnsw src/lib.rs:498-514) become
methods on a client object holding a registry of indexes (the equivalent
of the global ``INDICES`` map, src/lib.rs:32-35).

Command mapping:

    HNSW.NEW       -> create_index        (src/lib.rs:131-171)
    HNSW.GET       -> get_index / info    (src/lib.rs:173-190)
    HNSW.DEL       -> delete_index        (src/lib.rs:192-227)
    HNSW.NODE.ADD  -> add_node            (src/lib.rs:334-368)
    HNSW.NODE.GET  -> get_node            (src/lib.rs:425-444)
    HNSW.NODE.DEL  -> delete_node         (src/lib.rs:370-407)
    HNSW.SEARCH    -> search              (src/lib.rs:462-496)

Defaults mirror the reference: m=5, ef_construction=200, k=5
(src/lib.rs:48, :53, :120). Batched extensions: add_batch (bulk wave
construction on HNSW indexes, ops/construct.py; one table append on flat
ones), delete_batch, search_batch.

A client serves from one device: the card by default (``HNSW()``), the
CPU only when asked (``HNSW(device="cpu")``). ``save_index`` /
``restore_index`` write and read the JAX package's checkpoint files
(utils/checkpoint.py), so an index crosses between the packages through
them. Not ported yet, and raising ``NotImplementedError``:
``kind="sharded"`` and sharded checkpoint directories (ROADMAP queue 1
item 12).

``default_client`` is the module-level client of the JAX package (the
reference's process-global INDICES registry, src/lib.rs:32-35). It is
made on first access, on the card: an import never touches a device, and
without a card the access raises HNSWError rather than serve from the
CPU.
"""

from __future__ import annotations

import os
import threading

from .config import IndexConfig, resolve_device
from .errors import IndexExists, IndexNotFound
from .models.flat import FlatIndex
from .models.hnsw import HNSWIndex, SearchResult

DEFAULT_K = 5  # src/lib.rs:120


class HNSW:
    """A registry of named indexes -- the module-level INDICES equivalent."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._indices: dict[str, HNSWIndex | FlatIndex] = {}
        # The registry lock guards the name->index map only; every index
        # carries its OWN lock serializing its mutations and searches, so
        # operations on *different* indexes run concurrently (the
        # reference's per-index Arc<RwLock>, src/lib.rs:32-35).
        self._lock = threading.RLock()
        self._index_locks: dict[str, threading.RLock] = {}

    def _entry(self, name: str):
        """Resolve (index, its lock) under the registry lock."""
        with self._lock:
            idx = self._indices.get(name)
            if idx is None:
                raise IndexNotFound(name)
            return idx, self._index_locks[name]

    # -- index lifecycle ------------------------------------------------------

    def create_index(
        self,
        name: str,
        dim: int,
        m: int = 5,
        ef_construction: int = 200,
        metric: str = "euclidean",
        capacity: int = 1024,
        fixed_capacity: bool = False,
        seed: int | None = None,
        kind: str = "hnsw",
        backend: str = "auto",
        n_shards: int | None = None,
    ):
        """HNSW.NEW. Returns the index handle (reference returns "OK")."""
        with self._lock:
            if name in self._indices:
                raise IndexExists(name)
            cfg = IndexConfig(
                dim=dim,
                m=m,
                ef_construction=ef_construction,
                metric=metric,
                capacity=capacity,
                fixed_capacity=fixed_capacity,
                seed=seed,
                backend=backend,
            )
            if kind == "hnsw":
                idx = HNSWIndex(name, cfg, device=self.device)
            elif kind == "flat":
                idx = FlatIndex(name, cfg, device=self.device)
            elif kind == "sharded":
                raise NotImplementedError(
                    "kind='sharded' is not ported yet (ROADMAP queue 1 "
                    "item 12)"
                )
            else:
                raise ValueError(f"unknown index kind: {kind!r}")
            self._indices[name] = idx
            self._index_locks[name] = threading.RLock()
            return idx

    def index(self, name: str):
        with self._lock:
            idx = self._indices.get(name)
            if idx is None:
                raise IndexNotFound(name)
            return idx

    def get_index(self, name: str) -> dict:
        """HNSW.GET -- index metadata reply (src/types.rs:122-155)."""
        return self.index(name).info()

    def delete_index(self, name: str) -> int:
        """HNSW.DEL -- drops the index and all nodes; returns 1."""
        with self._lock:
            if name not in self._indices:
                raise IndexNotFound(name)
            del self._indices[name]
            del self._index_locks[name]
            return 1

    def list_indices(self) -> list[str]:
        with self._lock:
            return sorted(self._indices)

    # -- node ops -------------------------------------------------------------

    def add_node(self, index: str, node: str, data) -> None:
        idx, lk = self._entry(index)
        with lk:
            idx.add_node(node, data)

    def get_node(self, index: str, node: str) -> dict:
        idx, lk = self._entry(index)
        with lk:
            return idx.get_node(node)

    def delete_node(self, index: str, node: str) -> int:
        idx, lk = self._entry(index)
        with lk:
            idx.delete_node(node)
            return 1

    # -- search ---------------------------------------------------------------

    def search(
        self,
        index: str,
        query,
        k: int = DEFAULT_K,
        ef_search: int | None = None,
    ) -> list[SearchResult]:
        """HNSW.SEARCH -- single query, reference-parity semantics."""
        idx, lk = self._entry(index)
        with lk:
            if isinstance(idx, FlatIndex):
                return idx.search_knn(query, k)
            return idx.search_knn(query, k, ef_search=ef_search)

    # -- persistence (checkpoint/restore; reference: RDB callbacks) -------

    def save_index(self, index: str, path: str) -> None:
        """Checkpoint an index to one npz file (reference: RDB save
        callbacks, src/types.rs:157-284), in the JAX package's format
        v1 (utils/checkpoint.py)."""
        from .utils.checkpoint import save_index as _save

        idx, lk = self._entry(index)
        with lk:
            _save(idx, path)

    def restore_index(self, path: str, name: str | None = None):
        """Restore an index from a checkpoint of either package onto
        this client's device and register it (reference: RDB load +
        make_index rehydration, src/lib.rs:229-315), under ``name`` if
        given. A directory is a sharded checkpoint, which raises."""
        from .utils.checkpoint import load_index as _load

        if os.path.isdir(path):
            raise NotImplementedError(
                "sharded checkpoints (a directory with manifest.json) are "
                "not ported yet (ROADMAP queue 1 item 12)"
            )
        idx = _load(path, device=self.device)
        if name is not None:
            idx.name = name
        with self._lock:
            if idx.name in self._indices:
                raise IndexExists(idx.name)
            self._indices[idx.name] = idx
            self._index_locks[idx.name] = threading.RLock()
        return idx

    # -- batched extensions -------------------------------------------------------

    def add_batch(self, index: str, names, data, batch_size: int = 1024):
        """Bulk insert: device-scored waves of ``batch_size`` rows on an
        HNSW index (ops/construct.py), one append on a flat index."""
        idx, lk = self._entry(index)
        with lk:
            if isinstance(idx, FlatIndex):
                idx.add_batch(names, data)
            else:
                idx.add_batch(names, data, batch_size=batch_size)

    def delete_batch(self, index: str, nodes) -> int:
        """Bulk delete: validates every name before mutating; survivors
        are repaired once per layer with the whole delete set
        excluded."""
        nodes = list(nodes)
        idx, lk = self._entry(index)
        with lk:
            idx.delete_batch(nodes)
        return len(nodes)

    def search_batch(
        self,
        index: str,
        queries,
        k: int = DEFAULT_K,
        ef_search: int | None = None,
        expand: int = 1,
        iters: int | None = None,
        engine: str = "auto",
        reply: str = "objects",
        seeds: int = 0,
        recall_target: float | None = None,
        host_qs=None,
    ) -> list[list[SearchResult]]:
        """Batched device search (ops/search.py). ``engine`` routes
        between the exact scan and the graph traversal ("auto" serves
        the scan up to SCAN_MAX_ROWS padded rows and the graph beam
        above it; ``ef_search``, ``expand``, ``iters`` and ``seeds`` tune
        the beam; "scan-approx" is the approx tier). ``recall_target``
        turns "auto" into a guarantee. ``host_qs`` mirrors device-resident
        queries on the host for REDIS_HNSW_TPU_REPLY=ids. Flat indexes
        reply with objects, as in the JAX package."""
        idx, lk = self._entry(index)
        with lk:
            if isinstance(idx, FlatIndex):
                # Flat indexes have no graph: "auto"/"scan" are the
                # exact scan, "scan-approx" the approx tier; "graph" is
                # a user error, not a silent fallback.
                if engine not in ("auto", "scan", "scan-approx"):
                    raise ValueError(
                        f"engine {engine!r} unavailable on flat indexes"
                    )
                return idx.search_batch(
                    queries, k, approx=engine == "scan-approx",
                    recall_target=recall_target, host_qs=host_qs,
                )
            return idx.search_batch(
                queries, k, ef_search=ef_search, expand=expand,
                iters=iters, engine=engine, reply=reply, seeds=seeds,
                recall_target=recall_target, host_qs=host_qs,
            )


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: list[HNSW] = []


def __getattr__(name: str):
    """``default_client``: one HNSW() on the card, made on first access."""
    if name != "default_client":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    with _DEFAULT_LOCK:
        if not _DEFAULT:
            _DEFAULT.append(HNSW())
        return _DEFAULT[0]
