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

A client serves from one device type: the card by default (``HNSW()``),
the CPU only when asked (``HNSW(device="cpu")``). ``kind="sharded"``
(parallel/sharded.py) spreads an index over ``n_shards`` devices of that
type: cards (every visible one by default), or on the CPU the one CPU
device ``n_shards`` times (once by default). ``save_index`` /
``restore_index`` write and read the JAX package's checkpoint files
(utils/checkpoint.py) -- one npz, or a sharded index's directory -- so an
index crosses between the packages through them.

``default_client`` is the module-level client of the JAX package (the
reference's process-global INDICES registry, src/lib.rs:32-35). It is
made on first access, on the card: an import never touches a device, and
without a card the access raises HNSWError rather than serve from the
CPU.
"""

from __future__ import annotations

import collections
import functools
import os
import threading
from time import perf_counter_ns
from typing import TYPE_CHECKING

import numpy as np
import torch

from .config import IndexConfig, resolve_device
from .errors import IndexExists, IndexNotFound
from .models.flat import FlatIndex
from .models.hnsw import HNSWIndex
from .ops.cuda_scan import TILE
from .parallel.sharded import ShardedHNSW
from .utils import profiling

if TYPE_CHECKING:
    from .models.hnsw import SearchResult

DEFAULT_K = 5  # src/lib.rs:120


class _Waiter:
    """One thread's place in an index's queue, reused by each of its calls
    (a thread waits on one lock at a time): its wake-up, a lock held while
    the thread is not being woken, which the thread acquires to wait and
    another releases to wake it; and, for a search that may join a
    block, its request (``key``, ``qs``, ``n``) and what a holder left it
    (``reply`` or ``error``, ``block``, ``taken_ns``). ``held`` is set
    where it was handed the index's lock, ``members`` the requests it
    then took."""

    __slots__ = ("ident", "wake", "key", "qs", "n", "held", "members",
                 "reply", "error", "block", "taken_ns")

    def __init__(self) -> None:
        self.ident = threading.get_ident()
        self.wake = threading.Lock()
        self.wake.acquire()
        self.key = self.qs = self.reply = self.error = None
        self.n = self.block = self.taken_ns = 0
        self.held = False
        self.members = ()

    def result(self):
        """The reply a holder left, or its error raised; clears both."""
        reply, error = self.reply, self.error
        self.reply = self.error = None
        if error is not None:
            raise error
        return reply


class _Waiters(threading.local):
    def __init__(self) -> None:
        self.w = _Waiter()


_WAITERS = _Waiters()


class IndexLock:
    """An index's lock: reentrant, serializing the index's mutations and
    searches (the reference's per-index RwLock), handed on in arrival
    order, with a count of the callers that hold it or wait for it,
    their queued requests included (``_queued``). ``with lock:``, or
    :meth:`acquire` where the caller wants the count.

    **The combining front** (:meth:`join`, :meth:`hand_out`): a search
    that may share a pass with others queues its request; whoever is
    next handed the lock as such a search takes every queued request of
    its ``key``, in arrival order, while the block stays within one query
    tile of kernel A (ops/cuda_scan.py ``TILE``), serves the block with
    one search and hands each caller its rows, waking it; a served caller
    never takes the lock. A caller that finds the lock free and no one
    queued holds it at once. Writes queue as any caller does, so the
    holder serves while it excludes them."""

    __slots__ = ("_mutex", "_owner", "_depth", "_waiting", "_queued")

    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self._owner = None      # the holding thread's ident
        self._depth = 0         # its holds, nested ones included
        self._waiting: collections.deque = collections.deque()
        self._queued = 0

    def owned(self) -> bool:
        """Does the calling thread hold the lock?"""
        return self._owner == threading.get_ident()

    def acquire(self) -> int:
        """Take the lock; returns how many other callers held it or
        waited for it as this one began to wait."""
        w = _WAITERS.w
        ahead, held = self._ask(w, None)
        if not held:
            self._park(w)
        return ahead

    def release(self, served: int = 0) -> None:
        """Give up one hold (and the count of ``served`` requests a block
        answered); the last hands the lock to the first in the queue."""
        with self._mutex:
            if self._owner != threading.get_ident():
                raise RuntimeError("cannot release an index lock not held")
            self._queued -= 1 + served
            self._depth -= 1
            if self._depth:
                return
            nxt = self._waiting.popleft() if self._waiting else None
            self._owner = None
            if nxt is not None:
                self._owner, self._depth, nxt.held = nxt.ident, 1, True
                if nxt.key is not None:
                    nxt.members = self._take(nxt)
        if nxt is not None:
            nxt.wake.release()

    def join(self, key, qs) -> tuple[int, _Waiter]:
        """Queue the search request ``qs`` (``key`` says which requests
        it may share a pass with) and wait until this caller holds the
        lock (``held``, with the queued requests it took as ``members``)
        or another caller's block has answered it (:meth:`_Waiter.result`).
        Returns (the callers ahead as it began to wait, its waiter)."""
        w = _WAITERS.w
        w.qs, w.n = qs, int(qs.shape[0])
        ahead, held = self._ask(w, key)
        if not held:
            self._park(w)
        return ahead, w

    def hand_out(self, w: _Waiter, parts, error) -> None:
        """The holder ``w`` is done with its block: hand the lock on, then
        each member its part of ``parts`` (the holder's own first) or the
        block's ``error``, waking it."""
        members, w.members, w.qs = w.members, (), None
        self.release(served=len(members))
        block = 1 + len(members)
        for i, m in enumerate(members, 1):
            m.qs = None
            m.reply = None if parts is None else parts[i]
            m.error = error if parts is None else None
            m.block = block
            m.wake.release()

    def _ask(self, w: _Waiter, key) -> tuple[int, bool]:
        """Count the caller in; hold the lock where it is already this
        thread's, or free (no one then waits: a release hands it straight
        on), else queue ``w`` with ``key``. Returns (callers ahead,
        held)."""
        with self._mutex:
            ahead = self._queued
            self._queued += 1
            if self._owner == w.ident:
                self._depth += 1
                return ahead, True
            if self._owner is None:
                self._owner, self._depth = w.ident, 1
                w.held, w.members = True, ()
                return ahead, True
            w.key, w.held, w.members = key, False, ()
            self._waiting.append(w)
            return ahead, False

    def _take(self, w: _Waiter) -> list:
        """Under the mutex: take from the queue, in arrival order, the
        requests of ``w``'s key that fit beside it in one query tile."""
        members, keep, total = [], collections.deque(), w.n
        now = perf_counter_ns()
        for x in self._waiting:
            if x.key == w.key and total + x.n <= TILE:
                total += x.n
                x.taken_ns = now
                members.append(x)
            else:
                keep.append(x)
        self._waiting = keep
        return members

    def _park(self, w: _Waiter) -> None:
        """Wait to be woken. Interrupted, leave the queue; or hand on the
        lock handed over meanwhile, the requests taken with it queued
        again first; or take the reply being made and drop it: the
        waiter, the queue and the count stay sound."""
        try:
            w.wake.acquire()
        except BaseException:
            with self._mutex:
                queued = w in self._waiting
                if queued:
                    self._waiting.remove(w)
                    self._queued -= 1
            if not queued:
                w.wake.acquire()    # the wake-up already on its way
                if w.held:
                    with self._mutex:
                        self._waiting.extendleft(reversed(w.members))
                    w.members, w.qs = (), None
                    self.release()
                w.reply = w.error = None
            raise

    def __enter__(self) -> IndexLock:
        self.acquire()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.release()


def _alone(lk: IndexLock, serve, *args, **kw):
    """``serve(*args, **kw)`` under the index's lock, a block of one."""
    with profiling.span("lock_wait"):
        profiling.count("lock_waiters", lk.acquire())
    profiling.count("block_requests", 1)
    try:
        return serve(*args, **kw)
    finally:
        lk.release()


def _in_block(lk: IndexLock, serve, qs, key):
    """The reply to ``qs`` through ``lk``'s combining front: served by
    another caller's block, or as the holder, with one ``serve`` of its
    own queries and those of the requests it took, laid end to end."""
    with profiling.span("lock_wait"):
        ahead, w = lk.join(key, qs)
        woke = perf_counter_ns()
    profiling.count("lock_waiters", ahead)
    if not w.held:
        profiling.shift("lock_wait", "block_wait", woke - w.taken_ns)
        profiling.count("block_requests", w.block)
        return w.result()
    members = w.members
    profiling.count("block_requests", 1 + len(members))
    parts = error = None
    try:
        if not members:
            return serve(qs)
        parts = [qs, *(m.qs for m in members)]
        if isinstance(qs, torch.Tensor):
            block = torch.cat(parts)
        else:
            block = np.concatenate(parts)
        out = serve(block)
        ends = np.cumsum([len(p) for p in parts])
        parts = [out[lo:hi] for lo, hi in zip((0, *ends[:-1]), ends)]
        return parts[0]
    except BaseException as e:
        parts, error = None, e
        raise
    finally:
        lk.hand_out(w, parts, error)


class HNSW:
    """A registry of named indexes -- the module-level INDICES equivalent."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._indices: dict[str, HNSWIndex | FlatIndex | ShardedHNSW] = {}
        # The registry lock guards the name->index map only; every index
        # carries its OWN lock serializing its mutations and searches, so
        # operations on *different* indexes run concurrently (the
        # reference's per-index Arc<RwLock>, src/lib.rs:32-35).
        self._lock = threading.RLock()
        self._index_locks: dict[str, IndexLock] = {}

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
        """HNSW.NEW. Returns the index handle (reference returns "OK").
        ``kind="sharded"`` partitions the corpus over ``n_shards``
        devices of this client's type (see the module docstring)."""
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
                idx = ShardedHNSW(name, cfg, n_shards=n_shards,
                                  device=self.device)
            else:
                raise ValueError(f"unknown index kind: {kind!r}")
            self._indices[name] = idx
            self._index_locks[name] = IndexLock()
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
        """Checkpoint an index (reference: RDB save callbacks,
        src/types.rs:157-284) in the JAX package's format v1: one npz
        file (utils/checkpoint.py), or for a sharded index a directory of
        one npz per shard and a manifest."""
        from .utils.checkpoint import save_index as _save

        idx, lk = self._entry(index)
        with lk:
            if isinstance(idx, ShardedHNSW):
                idx.save(path)
            else:
                _save(idx, path)

    def restore_index(self, path: str, name: str | None = None):
        """Restore an index from a checkpoint of either package onto
        this client's device and register it (reference: RDB load +
        make_index rehydration, src/lib.rs:229-315), under ``name`` if
        given. A directory is a sharded checkpoint: its shards go to
        ``make_mesh(n_shards, device)`` of this client's device."""
        from .utils.checkpoint import load_index as _load

        if os.path.isdir(path):
            idx = ShardedHNSW.restore(path, device=self.device)
        else:
            idx = _load(path, device=self.device)
        if name is not None:
            idx.name = name
        with self._lock:
            if idx.name in self._indices:
                raise IndexExists(idx.name)
            self._indices[idx.name] = idx
            self._index_locks[idx.name] = IndexLock()
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
        reply with objects, as in the JAX package.

        On a flat index, calls that queue on the index's lock at once
        share a pass where they can (:class:`IndexLock`'s combining
        front): those with equal ``k``, ``engine``, ``reply`` and
        ``recall_target``, no ``host_qs``, and queries of one kind (host
        arrays, or tensors on one device), up to one query tile of kernel
        A in all. Each gets the reply to its own queries, as alone.

        Every call, a failed one too, writes one record of the request
        log (:meth:`request_log`); a block's work goes to the record of
        the caller that served it."""
        with profiling.request():
            idx, lk = self._entry(index)
            if not isinstance(idx, FlatIndex):
                return _alone(lk, idx.search_batch, queries, k,
                              ef_search=ef_search, expand=expand,
                              iters=iters, engine=engine, reply=reply,
                              seeds=seeds, recall_target=recall_target,
                              host_qs=host_qs)
            # Flat indexes have no graph: "auto"/"scan" are the exact
            # scan, "scan-approx" the approx tier; "graph" is a user
            # error, not a silent fallback.
            if engine not in ("auto", "scan", "scan-approx"):
                raise ValueError(
                    f"engine {engine!r} unavailable on flat indexes"
                )
            serve = functools.partial(
                idx.search_batch, k=k, approx=engine == "scan-approx",
                recall_target=recall_target,
            )
            if host_qs is not None or lk.owned():
                return _alone(lk, serve, queries, host_qs=host_qs)
            with profiling.span("prepare"):
                qs = idx.coerce_queries(queries)
            if qs.shape[0] > TILE:
                return _alone(lk, serve, qs)
            kind = qs.device if isinstance(qs, torch.Tensor) else "host"
            return _in_block(lk, serve, qs,
                             (k, engine, reply, recall_target, kind))

    @staticmethod
    def request_log(n: int = 128) -> dict:
        """The newest ``n`` records of the request log (at most
        ``utils.profiling.RING_ROWS``, oldest first), one per
        ``search_batch`` call of any client of this process, as
        ``{field: int64 array}``: the request's time, its lock wait and
        the callers ahead of it on the lock (``lock_waiters``), its wait
        inside another caller's block (``block_wait_ns``) and the
        requests that block answered (``block_requests``), the self
        time of each span of the serving path, the collector's pauses,
        queries, chunks, the queries the certified tier served and its
        fallback counts, those the exact tier served (``exact_queries``),
        the query lanes its kernels computed (``scan_lanes``), whether it
        failed (utils/profiling.py ``FIELDS``; times in ns)."""
        return profiling.recent(n)


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
