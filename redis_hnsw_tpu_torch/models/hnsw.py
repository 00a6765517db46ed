"""The HNSW index: host-authoritative graph + device-resident snapshots.

Port of ``redis_hnsw_tpu/models/hnsw.py``, itself a redesign of the
reference engine (zhao-lang/redis_hnsw src/hnsw/core.rs). The reference's
pointer graph (``HashMap<String, Arc<RwLock<_Node>>>`` + per-node
``Vec<Vec<NodeWeak>>``, core.rs:92-231, :302-319) becomes:

* a host-side **GraphStore**: dense numpy vector table + per-row adjacency
  lists + a name<->id table. All *mutations* (insert, delete, graph repair)
  run here with semantics matching the reference operation-for-operation --
  graph surgery is tiny, pointer-y work that stays on the host. This half
  is unchanged from the JAX package, so same-seed builds give the same
  graph;
* **device snapshots** (see ops/snapshot.py): padded dense int32
  adjacency + f32 vector tables as torch tensors on the index's device,
  refreshed lazily per mutation epoch, on which the batched search runs.

Key semantic notes (verified against the reference):

* Similarity is negative squared L2 (src/hnsw/metrics.rs:75-83); max-heap
  order on sim == nearest-first.
* ``select_neighbors`` (core.rs:677-757) is always called with
  ``extend_candidates=true, keep_pruned_connections=true`` (core.rs:528-529,
  :565-566, :850-851). Its diversity test compares a candidate's
  query-similarity against the *maximum selected* similarity
  (``enr.sim > r.peek().sim``, core.rs:733), which accepts only the first
  (best) candidate; ``keep_pruned_connections`` then backfills the rest in
  descending-sim order (core.rs:741-754). Net effect: **top-m by similarity
  over candidates U their layer-lc neighbors** (minus query/ignored). We
  implement exactly that, vectorized.
* Degree caps: m_max = m above layer 0, m_max_0 = 2m at layer 0
  (core.rs:335-336); enforced by re-selection + bidirectional pruning
  (core.rs:560-573, :776-822), which keeps adjacency symmetric.
* Level sampling: floor(-ln(U) * 1/ln(m)) (core.rs:601-605).
* Search: greedy descent (ef=1) from max_layer to 1, then an
  ef_construction-wide beam at layer 0 -- the reference has **no separate
  ef_search knob** (core.rs:485); we default to parity and expose
  ``ef_search`` as an extension.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from ..config import IndexConfig, resolve_device
from ..errors import (
    CapacityError,
    DimensionMismatch,
    HNSWError,
    NodeExists,
    NodeNotFound,
)
from ..ops import distance as D
from ..utils.names import NameTable


@dataclasses.dataclass(slots=True)
class SearchResult:
    """Mirror of the reference's SearchResult (core.rs:48-62).

    ``data`` is None in batch replies (the reference's search reply also
    carries only similarity + name, src/types.rs:445-457); single-query
    ``search_knn`` fills it like HNSW.NODE.GET would.
    """

    sim: float
    name: str
    data: np.ndarray | None = None


class HNSWIndex:
    """One HNSW index. Reference: ``Index<f32, f32>`` (core.rs:302-347)."""

    def __init__(self, name: str, config: IndexConfig, device=None) -> None:
        self.name = name
        self.config = config
        # Snapshots and searches run here; None means the card.
        self.device = resolve_device(device)
        cap = max(int(config.capacity), 8)
        self._vectors = np.zeros((cap, self._row_width()), self._row_dtype())
        self._levels = np.full(cap, -1, np.int32)
        # _neighbors[row] is None (free) or a list over layers 0..=level of
        # python-int lists (insertion-ordered, unique) -- semantics of the
        # reference's Vec<Vec<NodeWeak>> (core.rs:99). Unused (all None)
        # when the native backend owns the adjacency.
        self._neighbors: list[list[list[int]] | None] = [None] * cap
        # Native host graph core (C++, native/hnsw_core.cpp); None -> the
        # pure-Python paths below run instead, with identical semantics.
        self._native = None
        if config.backend in ("auto", "native"):
            from .. import native_core

            lib = native_core.load()
            if lib is None:
                if config.backend == "native":
                    raise HNSWError(
                        "native backend requested but "
                        "native/libhnswcore.so is unavailable"
                    )
            else:
                self._native = native_core.NativeGraph(
                    lib, config.m, config.m_max, config.m_max_0,
                    config.ef_construction, config.metric,
                    self._row_width(),
                )
                self._native.attach(self._vectors)
        self._names = NameTable()
        self.node_count = 0
        self.max_layer = 0
        self.enterpoint = -1
        # layers[l] = set of rows whose sampled level == l; mirrors the
        # reference's layers: Vec<HashSet<NodeWeak>> (core.rs:315) where each
        # node lives in exactly one set (add_node :399, insert :596).
        self._layer_sets: list[set[int]] = []
        self._rng = np.random.default_rng(config.seed)
        self._epoch = 0        # bumped on every mutation
        self._snapshot = None  # lazily-built device snapshot (ops/snapshot)
        self._snapshot_epoch = -1
        # Snapshot refreshes by kind: "full" rebuilds and in-place
        # "delta"s (ops/snapshot.py build_snapshot counts them).
        self.snapshot_refreshes = {"full": 0, "delta": 0}
        # Users presize via IndexConfig.capacity: device tables pad to it
        # up front so engine shapes stay stable for the expected size
        # (bulk builds and the streaming harness also raise this hint).
        self._capacity_hint = (
            int(config.capacity) if config.capacity > 1024 else 0
        )
        # Incremental-snapshot bookkeeping: rows whose adjacency changed
        # (python backend only -- the native core tracks its own, drained
        # via NativeGraph.drain_dirty), rows with new vectors, and a
        # *stable* row -> compact upper-layer slot assignment so delta
        # updates never reshuffle the adj_up table.
        self._dirty_adj: set[int] = set()
        self._dirty_vec: set[int] = set()
        self._upper_slot: dict[int, int] = {}
        self._upper_free: list[int] = []
        self._freed_slots_pending: list[int] = []
        self._upper_next = 0
        # Periodic write-through durability (see enable_autosave).
        self._autosave: tuple[str, int, bool] | None = None
        self._autosave_pending = 0

    # -- storage helpers ----------------------------------------------------

    def _row_dtype(self):
        return np.uint32 if self.config.metric == "hamming" else np.float32

    def _row_width(self) -> int:
        if self.config.metric == "hamming":
            return self.config.dim // 32
        return self.config.dim

    @property
    def capacity(self) -> int:
        return self._vectors.shape[0]

    @property
    def epoch(self) -> int:
        return self._epoch

    def _grow(self, need: int) -> None:
        cap = self.capacity
        if need <= cap:
            return
        if self.config.fixed_capacity:
            raise CapacityError(
                f"index at fixed capacity {self.config.capacity} "
                f"(need {need} rows)"
            )
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        vecs = np.zeros((new_cap, self._vectors.shape[1]), self._vectors.dtype)
        vecs[:cap] = self._vectors
        levels = np.full(new_cap, -1, np.int32)
        levels[:cap] = self._levels
        self._vectors = vecs
        self._levels = levels
        self._neighbors.extend([None] * (new_cap - cap))
        if self._native is not None:
            # the realloc moved the borrowed vector table
            self._native.attach(self._vectors)

    def _coerce(self, data) -> np.ndarray:
        arr = np.asarray(data, dtype=self._row_dtype()).ravel()
        # Reference dim checks: core.rs:389-391 (add), :478-480 (search).
        want = self.config.dim
        got = arr.size * (32 if self.config.metric == "hamming" else 1)
        if got != want:
            raise DimensionMismatch(got)
        return arr

    def _sims_to(self, q: np.ndarray, ids) -> np.ndarray:
        """Similarity of query vector q to each row id (f32)."""
        ids = np.asarray(ids, dtype=np.int64)
        return D.sim_np(q, self._vectors[ids], self.config.metric)

    def _nbrs(self, row: int, lc: int) -> list[int]:
        """Neighbor list at layer lc; missing layers read as empty.

        Matches the reference's lazy ``push_levels`` (core.rs:127-135): a
        node's list at a layer it has never been linked at is empty.
        """
        if self._native is not None:
            return self._native.neighbors(row, lc)
        lists = self._neighbors[row]
        if lists is None or lc >= len(lists):
            return []
        return lists[lc]

    def _layer_lists(self, row: int) -> list[list[int]]:
        """All layers' neighbor lists for one row (copy)."""
        if self._native is not None:
            return [
                self._native.neighbors(row, lc)
                for lc in range(self._native.n_layers(row))
            ]
        return [list(l) for l in (self._neighbors[row] or [])]

    def _is_alloc(self, row: int) -> bool:
        if self._native is not None:
            return self._native.level(row) >= 0
        return self._neighbors[row] is not None

    def _add_link(self, row: int, lc: int, other: int) -> None:
        """add_neighbor semantics (core.rs:137-143): grow layers, dedupe."""
        lists = self._neighbors[row]
        assert lists is not None
        while len(lists) < lc + 1:
            lists.append([])
        if other not in lists[lc]:
            lists[lc].append(other)
            self._dirty_adj.add(row)

    def _rm_link(self, row: int, lc: int, other: int) -> None:
        """rm_neighbor semantics (core.rs:145-152): must exist (symmetry)."""
        self._neighbors[row][lc].remove(other)
        self._dirty_adj.add(row)

    # -- level sampling (core.rs:601-605) ------------------------------------

    def _gen_random_level(self) -> int:
        r = self._rng.uniform(0.0, 1.0)
        return int(-math.log(r) * self.config.level_mult)

    # -- search_level: the reference hot loop (core.rs:607-675) --------------

    def _search_level(
        self, q: np.ndarray, ep: int, ef: int, lc: int
    ) -> list[tuple[float, int]]:
        """Beam search one layer; returns up to ef (sim, row) pairs.

        Faithful to core.rs:607-675: visited marks on discovery, accept if
        sim > current-worst or |W| < ef, pop-best expansion, early exit when
        best candidate < worst result.
        """
        visited = {ep}
        s0 = float(self._sims_to(q, [ep])[0])
        cand = [(-s0, ep)]          # max-heap on sim via negation
        res = [(s0, ep)]            # min-heap on sim (worst at root)
        while cand:
            cs, crow = heapq.heappop(cand)
            cs = -cs
            if cs < res[0][0]:
                break
            nbrs = self._nbrs(crow, lc)
            fresh = [n for n in nbrs if n not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            sims = self._sims_to(q, fresh)
            for row, s in zip(fresh, sims):
                s = float(s)
                if s > res[0][0] or len(res) < ef:
                    heapq.heappush(cand, (-s, row))
                    heapq.heappush(res, (s, row))
                    if len(res) > ef:
                        heapq.heappop(res)
        return res

    # -- select_neighbors (core.rs:677-757) ----------------------------------

    def _select_neighbors(
        self,
        q: np.ndarray,
        q_row: int,
        cand: list[tuple[float, int]],
        m: int,
        lc: int,
        ignored: int = -1,
        ignored_set: frozenset[int] | set[int] | None = None,
    ) -> list[tuple[float, int]]:
        """Top-m by sim over candidates U their layer-lc neighbors.

        Exact net semantics of the reference select_neighbors with both
        flags true (see module docstring). ``q_row``/``ignored`` rows are
        excluded (core.rs:704-707, :728-731). ``ignored_set`` generalizes
        ``ignored`` to a whole delete set for ``delete_batch``: candidates
        still extend one hop THROUGH deleted rows' lists (that is how the
        reference's repair finds replacement links, core.rs:834-853), but
        no deleted row can be selected. Returns descending by sim.
        """
        sims: dict[int, float] = {}
        for s, row in cand:
            sims[row] = float(s)
        # extend_candidates (core.rs:689-722): one-hop extension of every
        # candidate, deduped against candidates and each other.
        ext: list[int] = []
        for _, row in cand:
            for nb in self._nbrs(row, lc):
                if nb == q_row or nb == ignored or nb in sims:
                    continue
                if ignored_set is not None and nb in ignored_set:
                    continue
                sims[nb] = None  # placeholder; scored below
                ext.append(nb)
        if ext:
            for row, s in zip(ext, self._sims_to(q, ext)):
                sims[row] = float(s)
        sims.pop(q_row, None)
        sims.pop(ignored, None)
        if ignored_set is not None:
            for r in ignored_set:
                sims.pop(r, None)
        ranked = sorted(sims.items(), key=lambda kv: (-kv[1], kv[0]))
        return [(s, row) for row, s in ranked[:m]]

    # -- connect/prune (core.rs:759-822) --------------------------------------

    def _connect_neighbors(
        self, q_row: int, selected: list[tuple[float, int]], lc: int
    ) -> None:
        """Bidirectional linking (core.rs:759-774)."""
        for _, row in selected:
            self._add_link(q_row, lc, row)
            self._add_link(row, lc, q_row)

    def _update_connections(
        self,
        row: int,
        new_ids: list[int],
        old_ids: list[int],
        lc: int,
        ignored: int = -1,
        ignored_set: frozenset[int] | set[int] | None = None,
    ) -> None:
        """update_node_connections semantics (core.rs:776-822).

        Bidirectionally add every new link, then bidirectionally remove the
        old links not re-selected -- except that the ``ignored`` row (a node
        being deleted) keeps its own stale outgoing list (core.rs:810-816),
        which the deleter is about to free anyway. ``ignored_set`` is the
        whole-set generalization used by ``delete_batch``.
        """
        new_set = set(new_ids)
        for nb in new_ids:
            self._add_link(row, lc, nb)
            self._add_link(nb, lc, row)
        for nb in old_ids:
            if nb in new_set:
                continue
            self._rm_link(row, lc, nb)
            if nb != ignored and (
                ignored_set is None or nb not in ignored_set
            ):
                self._rm_link(nb, lc, row)

    # -- public API: add (core.rs:383-412, :489-599) ---------------------------

    def add_node(self, name: str, data) -> None:
        if not name:
            # "" is the checkpoint format's free-row sentinel; an
            # empty-named live node would corrupt restore (ADVICE r1)
            raise HNSWError("node name must be non-empty")
        q = self._coerce(data)
        if self.node_count == 0:
            # First-node fast path (core.rs:393-405).
            if name in self._names:
                raise NodeExists(name)
            row = self._alloc_row(name, q, level=0)
            self.enterpoint = row
            if not self._layer_sets:
                self._layer_sets.append(set())
            self._layer_sets[0].add(row)
            self._bump()
            return
        if name in self._names:
            raise NodeExists(name)
        self._insert(name, q)
        self._bump()

    def _alloc_row(self, name: str, q: np.ndarray, level: int) -> int:
        row = self._names.alloc(name)
        try:
            self._grow(row + 1)
        except CapacityError:
            self._names.free(name)  # leave the name table consistent
            raise
        self._vectors[row] = q
        self._levels[row] = level
        if self._native is not None:
            self._native.alloc_node(row, level)
        else:
            self._neighbors[row] = [[] for _ in range(level + 1)]
            self._dirty_adj.add(row)
        self._dirty_vec.add(row)
        if level >= 1 and row not in self._upper_slot:
            self._upper_slot[row] = (
                self._upper_free.pop()
                if self._upper_free
                else self._upper_next
            )
            if self._upper_slot[row] == self._upper_next:
                self._upper_next += 1
        self.node_count += 1
        return row

    def _insert(self, name: str, q: np.ndarray) -> None:
        """The insert path (core.rs:489-599)."""
        l = self._gen_random_level()
        l_max = self.max_layer
        row = self._alloc_row(name, q, level=l)

        if self._native is not None:
            self._native.insert(row, l, q, self.enterpoint, l_max)
            self._finish_insert(row, l)
            return

        ep = self.enterpoint
        # Greedy descent, ef=1, layers l_max .. l+1 (core.rs:511-520).
        lc = l_max
        while lc > l:
            w = self._search_level(q, ep, 1, lc)
            ep = max(w)[1]
            if lc == 0:
                break
            lc -= 1

        # Per-layer beam + select + connect + shrink (core.rs:523-577).
        for lc in range(min(l_max, l), -1, -1):
            w = self._search_level(q, ep, self.config.ef_construction, lc)
            selected = self._select_neighbors(q, row, w, self.config.m, lc)
            self._connect_neighbors(row, selected, lc)

            # Shrink any over-cap neighbor (core.rs:540-574). The reference
            # pops its heap best-first; order is irrelevant to the result
            # set of each independent shrink, but we match it anyway.
            m_cap = self.config.m_max_0 if lc == 0 else self.config.m_max
            for _, e_row in selected:
                e_nbrs = list(self._nbrs(e_row, lc))
                if len(e_nbrs) <= m_cap:
                    continue
                e_vec = self._vectors[e_row]
                e_sims = self._sims_to(e_vec, e_nbrs)
                econn = [(float(s), r) for s, r in zip(e_sims, e_nbrs)]
                enew = self._select_neighbors(
                    e_vec, e_row, econn, m_cap, lc
                )
                self._update_connections(
                    e_row, [r for _, r in enew], e_nbrs, lc
                )

            ep = max(w)[1]  # w.peek() -- best of the beam (core.rs:576)

        self._finish_insert(row, l)

    def _finish_insert(self, row: int, l: int) -> None:
        """Enterpoint / layer bookkeeping (core.rs:587-597).

        Compares against the *current* max_layer so wave builds applying
        several inserts back-to-back promote the enterpoint correctly.
        """
        if l > self.max_layer:
            self.max_layer = l
            self.enterpoint = row
        while len(self._layer_sets) < l + 1:
            self._layer_sets.append(set())
        self._layer_sets[l].add(row)

    # -- public API: delete (core.rs:414-475, :824-863) -------------------------

    def delete_node(self, name: str) -> None:
        row = self._names.get(name)
        if row is None:
            raise NodeNotFound(name)
        self._names.free(name)
        self.node_count -= 1

        # Remove from its (single) layer set (core.rs:426-430).
        for lc in range(self.max_layer, -1, -1):
            if lc < len(self._layer_sets) and row in self._layer_sets[lc]:
                self._layer_sets[lc].discard(row)
                break

        # Repair every ex-neighbor at every layer (core.rs:432-439, :824-863).
        if self._native is not None:
            self._native.delete(row)
        else:
            my_lists = self._neighbors[row]
            for lc in range(len(my_lists)):
                for n_row in list(my_lists[lc]):
                    n_nbrs = list(self._nbrs(n_row, lc))
                    n_vec = self._vectors[n_row]
                    n_sims = self._sims_to(n_vec, n_nbrs)
                    nconn = [(float(s), r) for s, r in zip(n_sims, n_nbrs)]
                    m_cap = (
                        self.config.m_max_0 if lc == 0 else self.config.m_max
                    )
                    nnew = self._select_neighbors(
                        n_vec, n_row, nconn, m_cap, lc, ignored=row
                    )
                    self._update_connections(
                        n_row, [r for _, r in nnew], n_nbrs, lc, ignored=row
                    )

        # Enterpoint re-election + empty-top-layer popping (core.rs:449-472).
        if row == self.enterpoint:
            new_ep = -1
            for lc in range(self.max_layer, -1, -1):
                if lc < len(self._layer_sets) and self._layer_sets[lc]:
                    # Deterministic stand-in for HashSet::iter().next().
                    new_ep = min(self._layer_sets[lc])
                    break
                if lc < len(self._layer_sets):
                    self._layer_sets.pop()
                if self.max_layer > 0:
                    self.max_layer -= 1
            self.enterpoint = new_ep

        # Free the row.
        self._levels[row] = -1
        self._neighbors[row] = None
        if self._native is None:
            self._dirty_adj.add(row)
        slot = self._upper_slot.pop(row, None)
        if slot is not None:
            self._upper_free.append(slot)
            self._freed_slots_pending.append(slot)
        self._bump()

    def delete_batch(self, names) -> None:
        """Bulk delete with one-shot survivor repair (batch extension;
        the delete-side counterpart of ``add_batch``).

        The reference deletes one node at a time, repairing every
        ex-neighbor per delete (core.rs:414-475, :824-863). A sequential
        loop over a large delete set therefore (a) repairs rows that are
        themselves about to be deleted and (b) re-repairs the same
        survivor once per deleted neighbor. ``delete_batch`` instead:

        * validates every name up front -- nothing mutates on error;
        * repairs each affected SURVIVOR exactly once per layer, with the
          whole delete set excluded (the reference's single-row
          ``ignored`` generalized to a set; candidates still extend one
          hop through the deleted rows' own lists, which is how the
          repair finds replacement links);
        * then frees all rows, re-elects the enterpoint once, and bumps
          one snapshot epoch.

        Like ``add_batch``, this is a documented approximation of the
        sequential loop (the surviving graph can differ from N single
        deletes; graph invariants and recall floors are pinned by tests).
        Repair order is deterministic: layer ascending, survivor row
        ascending -- kept in lockstep with native/hnsw_core.cpp
        ``delete_batch``.
        """
        names = list(names)
        rows: list[int] = []
        seen: set[int] = set()
        for name in names:
            row = self._names.get(name)
            if row is None or row in seen:
                raise NodeNotFound(name)
            seen.add(row)
            rows.append(row)
        if not rows:
            return
        dset = frozenset(rows)

        # Layer-set removal (delete_node order; core.rs:426-430).
        for row in rows:
            for lc in range(self.max_layer, -1, -1):
                if (
                    lc < len(self._layer_sets)
                    and row in self._layer_sets[lc]
                ):
                    self._layer_sets[lc].discard(row)
                    break

        if self._native is not None:
            self._native.delete_batch(rows)
        else:
            # Affected survivors per layer, from the delete set's lists.
            affected: dict[int, set[int]] = {}
            for d in rows:
                for lc, lst in enumerate(self._neighbors[d] or []):
                    for nb in lst:
                        if nb not in dset:
                            affected.setdefault(lc, set()).add(nb)
            for lc in sorted(affected):
                m_cap = (
                    self.config.m_max_0 if lc == 0 else self.config.m_max
                )
                for n_row in sorted(affected[lc]):
                    n_nbrs = list(self._nbrs(n_row, lc))
                    if not n_nbrs:
                        continue
                    n_vec = self._vectors[n_row]
                    n_sims = self._sims_to(n_vec, n_nbrs)
                    nconn = [
                        (float(s), r) for s, r in zip(n_sims, n_nbrs)
                    ]
                    nnew = self._select_neighbors(
                        n_vec, n_row, nconn, m_cap, lc, ignored_set=dset
                    )
                    self._update_connections(
                        n_row,
                        [r for _, r in nnew],
                        n_nbrs,
                        lc,
                        ignored_set=dset,
                    )

        # Free every row (core.rs:419-424 bookkeeping, batched).
        for name, row in zip(names, rows):
            self._names.free(name)
            self._levels[row] = -1
            self._neighbors[row] = None
            if self._native is None:
                self._dirty_adj.add(row)
            slot = self._upper_slot.pop(row, None)
            if slot is not None:
                self._upper_free.append(slot)
                self._freed_slots_pending.append(slot)
        self.node_count -= len(rows)

        # Enterpoint re-election + empty-top-layer popping, once
        # (core.rs:449-472).
        if self.enterpoint in dset:
            new_ep = -1
            for lc in range(self.max_layer, -1, -1):
                if (
                    lc < len(self._layer_sets)
                    and self._layer_sets[lc]
                ):
                    new_ep = min(self._layer_sets[lc])
                    break
                if lc < len(self._layer_sets):
                    self._layer_sets.pop()
                if self.max_layer > 0:
                    self.max_layer -= 1
            self.enterpoint = new_ep
        self._bump()

    # -- public API: search (core.rs:477-486, :865-892) --------------------------

    def search_knn(
        self, data, k: int, ef_search: int | None = None
    ) -> list[SearchResult]:
        """Single-query host search, reference-exact semantics.

        ``ef_search=None`` reproduces the reference's hardwired
        ef=ef_construction (core.rs:485). The batched device path is
        ``search_batch`` (ops/search.py).
        """
        q = self._coerce(data)
        if self.enterpoint < 0 or self.node_count == 0:
            return []
        ef = self.config.ef_construction if ef_search is None else ef_search

        if self._native is not None:
            ids, sims = self._native.search(
                q, k, ef, self.enterpoint, self.max_layer
            )
            return [
                SearchResult(
                    sim=float(s),
                    name=self._names.name(int(r)),
                    data=self._vectors[int(r)].copy(),
                )
                for r, s in zip(ids, sims)
            ]

        ep = self.enterpoint
        for lc in range(self.max_layer, 0, -1):
            w = self._search_level(q, ep, 1, lc)
            ep = max(w)[1]
        w = self._search_level(q, ep, ef, 0)

        out: list[SearchResult] = []
        for s, row in sorted(w, key=lambda p: (-p[0], p[1]))[:k]:
            out.append(
                SearchResult(
                    sim=float(s),
                    name=self._names.name(row),
                    data=self._vectors[row].copy(),
                )
            )
        return out

    # -- introspection (types.rs:122-155, :322-352) ------------------------------

    def info(self) -> dict:
        """HNSW.GET reply fields (src/types.rs:122-155)."""
        return {
            "name": self.name,
            "metric": self.config.metric.capitalize(),
            "data_dim": self.config.dim,
            "m": self.config.m,
            "ef_construction": self.config.ef_construction,
            "level_mult": self.config.level_mult,
            "node_count": self.node_count,
            "max_layer": self.max_layer,
            "enterpoint": (
                self._names.name(self.enterpoint)
                if self.enterpoint >= 0
                else None
            ),
        }

    def get_node(self, name: str) -> dict:
        """HNSW.NODE.GET reply (src/types.rs:322-352): data + neighbor names
        per layer."""
        row = self._names.get(name)
        if row is None:
            raise NodeNotFound(name)
        return {
            "data": self._vectors[row].copy(),
            "neighbors": [
                [self._names.name(n) for n in layer]
                for layer in self._layer_lists(row)
            ],
        }

    def node_names(self) -> list[str]:
        return self._names.names()

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __len__(self) -> int:
        return self.node_count

    # -- durability -----------------------------------------------------------

    def enable_autosave(self, path: str, every_ops: int = 8192,
                        compress: bool = False) -> None:
        """Bounded-loss write-through persistence.

        The reference persists every dirtied node on every mutation
        (src/lib.rs:446-460, update_fn at src/hnsw/core.rs:580-584), so a
        crash loses nothing. Here one atomic full checkpoint
        (utils/checkpoint.py, tmp + rename) lands after every
        ``every_ops`` mutations -- a bulk wave counts its W inserts --
        so the loss bound is a knob; ``every_ops=1`` recovers the
        reference's durability for sequential workloads.
        """
        self._autosave = (str(path), max(1, int(every_ops)), bool(compress))
        self._autosave_pending = 0

    def disable_autosave(self) -> None:
        self._autosave = None

    def _maybe_autosave(self, ops: int) -> None:
        if self._autosave is None:
            return
        self._autosave_pending += ops
        path, every, compress = self._autosave
        if self._autosave_pending >= every:
            from ..utils.checkpoint import save_index

            save_index(self, path, compress=compress)
            self._autosave_pending = 0

    # -- device snapshot plumbing -------------------------------------------

    def _bump(self, ops: int = 1) -> None:
        """A new mutation epoch; ``ops`` counts the mutations it holds (a
        bulk wave is one epoch of W inserts) toward autosave's cadence."""
        self._epoch += 1
        self._maybe_autosave(ops)

    def drain_dirty(self) -> np.ndarray:
        """Rows whose adjacency changed since the last snapshot (clears)."""
        if self._native is not None:
            return self._native.drain_dirty()
        out = np.fromiter(self._dirty_adj, np.int32, len(self._dirty_adj))
        self._dirty_adj.clear()
        return out

    def device_snapshot(self, max_staleness: int = 0):
        """Dense device-resident snapshot for the batched search.

        Cached per mutation epoch; refreshed incrementally (dirty rows
        copied in place) when shapes allow -- see ops/snapshot.py. The
        refresh writes into the previous snapshot's tensors, so callers
        must NOT hold a returned Snapshot across a later mutation --
        re-fetch it here each time (free when the epoch is unchanged).

        ``max_staleness`` > 0 returns the already-built snapshot when it
        lags the index by at most that many mutation epochs, instead of
        applying the dirty-row delta: a query sees the index as of that
        snapshot -- bounded, documented staleness. Rows allocated after
        the snapshot (``live_hw``) are invisible; rows deleted after it
        are still served as they were. The stale view is the live
        cache: the NEXT refresh writes into its tensors, so callers must
        finish consuming results before triggering one.
        """
        if self._snapshot is not None and (
            0 < self._epoch - self._snapshot_epoch <= max_staleness
        ):
            return self._snapshot
        if self._snapshot is None or self._snapshot_epoch != self._epoch:
            from ..ops.snapshot import build_snapshot

            self._snapshot = build_snapshot(self, prev=self._snapshot)
            self._snapshot_epoch = self._epoch
        return self._snapshot

    # -- batched entry points -------------------------------------------------

    def add_batch(self, names, data, batch_size: int = 1024) -> None:
        """Bulk wave construction (device-scored). See ops/construct.py."""
        from ..ops.construct import add_batch as _add_batch

        _add_batch(self, names, data, batch_size=batch_size)

    def search_batch(
        self, queries, k: int, ef_search: int | None = None,
        expand: int = 1, iters: int | None = None, engine: str = "auto",
        reply: str = "objects", seeds: int = 0,
        recall_target: float | None = None, host_qs=None,
        staleness: int = 0,
    ) -> list[list[SearchResult]]:
        """Batched device search. See ops/search.py.

        ``engine`` routes between the exact scan and the graph
        traversal: "auto" serves the scan up to ops/search.py
        SCAN_MAX_ROWS padded rows and the graph beam above it;
        "scan-approx" is the approx tier. ``ef_search`` (default
        ef_construction), ``expand``, ``iters`` and ``seeds`` tune the
        graph traversal; the scan ignores them. ``recall_target`` makes
        the "auto" route a guarantee (ops/search.py resolve_engine).
        ``host_qs`` mirrors device-resident ``queries`` on the host, so
        REDIS_HNSW_TPU_REPLY=ids can rescore sims there (ops/scan.py
        reply_ids_engaged); ignored otherwise. ``staleness`` > 0 serves
        from the bounded-stale device view (see ``device_snapshot``).
        """
        from ..ops.search import search_batch as _search_batch

        return _search_batch(
            self, queries, k, ef_search=ef_search, expand=expand,
            iters=iters, engine=engine, reply=reply, seeds=seeds,
            recall_target=recall_target, host_qs=host_qs,
            staleness=staleness,
        )
