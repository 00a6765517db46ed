"""The sharded index: S independent sub-indexes presented as one index.

Port of ``redis_hnsw_tpu/parallel/sharded.py``. The corpus is
hash-partitioned into S HNSW sub-indexes (crc32 of the name mod S), one
per mesh position (parallel/mesh.py). A query batch goes to every shard;
each shard serves it on its own device with the single-index engines
(ops/scan.py, ops/search.py) and their kernels, and the per-shard [B, k]
lists are merged into one [B, k] reply. Graph traversal never crosses a
shard boundary: the merge is the only communication.

The JAX package runs every shard inside one ``shard_map`` program and
lets GSPMD insert the all-gather of the merge. Here one process drives
the list of ``torch.device`` objects itself, as the JAX package's one
``ShardedHNSW`` object drives its mesh: each shard's snapshot lives on
its own device, its work is launched there (under
``torch.cuda.device``), and the per-shard lists are copied to the mesh's
first device and merged there (:func:`_merge_stacked_topk`; innermost
mesh axis first on a 2-D mesh, :func:`_merge_topk_over`). Several shards
may share one device.

What keeps the replies equal to the JAX package's:

* a row's global id is ``s * n_pad + row``, ``n_pad`` the LARGEST padded
  row count over the shards, and the merge is a stable descending sort
  of the shard-major flattening, so ties go to the lower global id as
  under ``lax.top_k``;
* the routing gates (``SCAN_MAX_ROWS``, ``certified_serves``, the chunk
  width) are judged on that ``n_pad``;
* frontier tables are used only when every shard has one of the same
  dtype, and the graph path passes no int8 row table (``qrows``);
* seeded beams scan each shard's pivot pool at ``k = min(seeds,
  PIVOT_POOL)``, slots past the pool's live rows empty;
* an empty shard contributes -1 / -inf.

Nothing is stacked or padded into one array: each shard serves from its
own ``device_snapshot()`` and its own scan tables (ops/scan.py
``_scan_state``, cached per shard by (snapshot epoch, tier)).

Hamming tables are scanned as packed words by kernel A′, as on one card,
and with REDIS_HNSW_TPU_SCAN_CERT=1 on the certified hamming tier (the
JAX package's sharded twin: per shard kernel A′ at the oversampled width,
kernel B′'s counts and the deep verdict, ANDed across shards, then the
same merge). Query blocks larger than one chunk go through the
single index's pipelined drain (ops/scan.py ``drain_pipelined``): each
chunk's dispatch half queues every shard's kernels and the merge and
registers the merged lists with ``fetch_handle``; its finish half reads
the certified verdicts and hands the uncertified rows to a sink that
serves them again in one exact sharded scan. Every chunk takes the
certified tier here, as in the JAX package: the single index's fallback
history, which skips a certificate that keeps failing (ops/scan.py
``CertHistory``), is not kept for the shards. The JAX package's packed
[B, 2k+1] replies are not ported: each list is its own slice of the
window's copy.
"""

from __future__ import annotations

import contextlib
import json
import os
import zlib
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..config import IndexConfig
from ..errors import NodeNotFound
from ..models.hnsw import HNSWIndex
from ..utils import profiling
from .mesh import DATA_AXIS, Mesh, make_mesh

if TYPE_CHECKING:
    from ..models.hnsw import SearchResult

NEG_INF = float("-inf")


def _shard_of(name: str, n_shards: int) -> int:
    return zlib.crc32(name.encode("utf-8")) % n_shards


def _devctx(dev):
    """Launch on ``dev``: the counterpart of ``jax.default_device``."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _merge_stacked_topk(gids, sims, k: int):
    """[S, B, kk] stacked per-shard candidates -> the per-query merged
    top ``min(k, S * kk)``, in (-sim, shard-major position) order: a
    stable descending sort, which breaks ties by the lower index as
    ``lax.top_k`` does (``torch.topk`` gives no tie order). -inf slots
    sort last in index order."""
    S, B, kk = gids.shape
    fs = sims.permute(1, 0, 2).reshape(B, S * kk)
    fg = gids.permute(1, 0, 2).reshape(B, S * kk)
    top, order = torch.sort(fs, dim=1, descending=True, stable=True)
    w = min(int(k), S * kk)
    return fg.gather(1, order[:, :w]), top[:, :w]


def _merge_topk_over(parts, grid_shape, k: int):
    """Merge the per-shard (gids, sims) [B, kk] lists, given in row-major
    mesh order, innermost mesh axis first: on a (slice, data) mesh each
    slice's lists reduce to one first, then the slices' lists do, as the
    JAX package's hierarchical merge runs. The result is the one-stage
    merge's: every stage keeps the (-sim, global id) order."""
    level = list(parts)
    for size in reversed(tuple(grid_shape)):
        level = [
            _merge_stacked_topk(
                torch.stack([g for g, _ in level[lo : lo + size]]),
                torch.stack([s for _, s in level[lo : lo + size]]), k,
            )
            for lo in range(0, len(level), size)
        ]
    return level[0]


def _empty_block(b: int, kk: int, dev):
    return (torch.full((b, kk), -1, dtype=torch.int64, device=dev),
            torch.full((b, kk), NEG_INF, dtype=torch.float32, device=dev))


def _global(ids, s: int, n_pad: int, dev0):
    """Local row ids -> global ids ``s * n_pad + row`` (-1 kept), as int64
    on the merge device."""
    ids = ids.to(torch.int64)
    return torch.where(ids >= 0, ids + s * n_pad, -1).to(dev0)


def resolve_mesh(mesh=None, n_shards: int | None = None, device=None) -> Mesh:
    """``mesh`` as a :class:`~.mesh.Mesh`: a Mesh as is, any sequence of
    devices (repeats included) as a 1-D mesh, and without one
    ``make_mesh(n_shards, device)``."""
    if mesh is None:
        return make_mesh(n_shards, device)
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(list(mesh), (DATA_AXIS,))


class _ShardedCertRerunSink:
    """The sharded certified tier's fallback reruns across a drain: each
    chunk's finish registers its uncertified rows (host queries) and
    its writable reply arrays; :meth:`flush` serves every registered row
    again in ONE exact sharded scan and splices the rows back in place
    (ops/scan.py ``CertRerunSink``'s contract)."""

    def __init__(self, index, states, k: int, n_pad: int) -> None:
        self._index = index
        self._states = states
        self._k = k
        self._n_pad = n_pad
        self._items: list = []

    def add(self, part, bad, gids, sims) -> None:
        self._items.append((part, np.asarray(bad), gids, sims))

    def flush(self) -> None:
        if not self._items:
            return
        rows = np.concatenate([p[b] for p, b, _, _ in self._items])
        gb, sb, _ = self._index._scan_chunk(
            self._states, self._index._device_queries(rows), 0, len(rows),
            self._k, self._n_pad, cert=False)
        with profiling.span("card_wait"):
            gb = gb[: len(rows)].cpu().numpy()
            sb = sb[: len(rows)].cpu().numpy()
        lo = 0
        for _, bad, gids, sims in self._items:
            gids[bad] = gb[lo : lo + len(bad)]
            sims[bad] = sb[lo : lo + len(bad)]
            lo += len(bad)
        self._items.clear()


class ShardedHNSW:
    """S independent sub-indexes presented as one index.

    ``mesh`` is a :class:`~.mesh.Mesh` or any sequence of devices
    (repeats included; a sequence is a 1-D mesh). Without one, the mesh
    is ``make_mesh(n_shards, device)``: ``n_shards`` cards (the CPU
    ``n_shards`` times), every visible card with ``n_shards=None``.
    Shard s lives on the mesh's s-th device in row-major order.
    ``shards`` (one HNSWIndex per mesh position, each on its device)
    takes the place of the empty shards, as a restore gives them."""

    def __init__(
        self,
        name: str,
        config: IndexConfig,
        n_shards: int | None = None,
        mesh=None,
        device=None,
        shards=None,
    ) -> None:
        self.name = name
        self.config = config
        self.mesh = resolve_mesh(mesh, n_shards, device)
        self.n_shards = self.mesh.devices.size
        self.devices = list(self.mesh.devices.flat)
        if shards is not None:
            self.shards = list(shards)
            return
        base_seed = config.seed if config.seed is not None else 0
        self.shards = [
            HNSWIndex(
                f"{name}/shard{s}",
                IndexConfig(
                    dim=config.dim,
                    m=config.m,
                    ef_construction=config.ef_construction,
                    metric=config.metric,
                    capacity=config.capacity,
                    seed=base_seed + s,
                    backend=config.backend,
                ),
                device=self.devices[s],
            )
            for s in range(self.n_shards)
        ]

    # -- mutation: dispatch by stable hash ------------------------------------

    def _shard(self, node: str) -> HNSWIndex:
        return self.shards[_shard_of(node, self.n_shards)]

    def add_node(self, name: str, data) -> None:
        self._shard(name).add_node(name, data)

    def delete_node(self, name: str) -> None:
        self._shard(name).delete_node(name)

    def delete_batch(self, names) -> None:
        """Bulk delete, hashed to shards; every name is validated before
        any shard mutates (each shard's ``delete_batch`` then repairs its
        survivors once)."""
        buckets: dict[int, list[str]] = {}
        seen: set[str] = set()
        for n in names:
            if self._shard(n)._names.get(n) is None or n in seen:
                raise NodeNotFound(n)
            seen.add(n)
            buckets.setdefault(_shard_of(n, self.n_shards), []).append(n)
        for s, ns in sorted(buckets.items()):
            self.shards[s].delete_batch(ns)

    def get_node(self, name: str) -> dict:
        return self._shard(name).get_node(name)

    def add_batch(
        self, names, data, batch_size: int = 1024, interleave: bool = True,
    ) -> None:
        """Bulk insert, hashed to shards, with the shards' construction
        waves INTERLEAVED: each shard's next device pass
        (ops/construct.py ``dispatch_wave``) is queued on its device
        before the host surgery of the others' waves runs. Waves within
        a shard stay in order (each reads the graph the previous one
        wrote), so the graphs are the ones a plain per-shard build gives
        (``interleave=False``). On the card the beams of a device pass
        sync the host once per step, so the overlap is partial."""
        from ..ops.construct import complete_wave, dispatch_wave
        from ..ops.search import max_lanes_for

        names = list(names)
        data = np.atleast_2d(
            np.asarray(data, dtype=self.shards[0]._vectors.dtype))
        if len(names) != data.shape[0]:
            raise ValueError(
                f"{len(names)} names for {data.shape[0]} data rows")
        buckets: dict[int, tuple[list, list]] = {}
        for i, n in enumerate(names):
            b = buckets.setdefault(_shard_of(n, self.n_shards), ([], []))
            b[0].append(n)
            b[1].append(i)
        if not interleave:
            for s, (ns, rows) in buckets.items():
                self.shards[s].add_batch(ns, data[rows],
                                         batch_size=batch_size)
            return

        work: dict[int, tuple[list, np.ndarray, int]] = {}
        for s, (ns, rows) in sorted(buckets.items()):
            shard = self.shards[s]
            d = data[rows]
            shard._capacity_hint = max(
                int(shard._capacity_hint),
                shard._names.high_water + len(ns),
            )
            pos = 0
            if shard.node_count == 0:
                shard.add_node(ns[0], d[0])
                pos = 1
            if pos < len(ns):
                work[s] = (ns, d, pos)

        inflight: dict[int, object] = {}

        def dispatch_next(s: int) -> None:
            ns, d, pos = work[s]
            if pos >= len(ns):
                return
            shard = self.shards[s]
            with _devctx(self.devices[s]):
                with profiling.span("snapshot_refresh"):
                    cap = max_lanes_for(shard.device_snapshot().n_pad)
                hi = min(pos + min(batch_size, cap), len(ns))
                inflight[s] = dispatch_wave(
                    shard, ns[pos:hi], d[pos:hi],
                    shard.config.ef_construction,
                )
            work[s] = (ns, d, hi)

        order = sorted(work)
        for s in order:
            dispatch_next(s)
        while inflight:
            for s in order:
                if s not in inflight:
                    continue
                wave = inflight.pop(s)
                with _devctx(self.devices[s]):
                    complete_wave(self.shards[s], wave)
                dispatch_next(s)

    @property
    def node_count(self) -> int:
        return sum(s.node_count for s in self.shards)

    def __len__(self) -> int:
        return self.node_count

    def info(self) -> dict:
        out = self.shards[0].info()
        out.update(
            name=self.name,
            node_count=self.node_count,
            max_layer=max(s.max_layer for s in self.shards),
            enterpoint=None,
            n_shards=self.n_shards,
        )
        return out

    # -- search -----------------------------------------------------------------

    def search_knn(
        self, data, k: int, ef_search: int | None = None
    ) -> list[SearchResult]:
        """Single-query host search across all shards: each shard's
        reference-exact ``search_knn``, merged by (-sim, name) (shard-local
        row ids mean nothing globally, so the name breaks ties)."""
        merged = [
            r for s in self.shards
            for r in s.search_knn(data, k, ef_search=ef_search)
        ]
        merged.sort(key=lambda r: (-r.sim, r.name))
        return merged[:k]

    def _device_queries(self, qs) -> dict:
        """The host query block ``qs`` on each of the mesh's devices, one
        copy a device, so the chunks below are device-side slices."""
        from ..ops import scan as SC

        out = {}
        for dev in self.devices:
            if dev not in out:
                out[dev] = SC.pad_queries(qs, qs.shape[0], dev)
        return out

    def _merged(self, qds, lo: int, pn: int, kk: int, k: int, n_pad: int,
                serve_shard):
        """Queue rows ``lo:lo + pn`` of the query blocks ``qds`` (one a
        device, :meth:`_device_queries`) on every shard, then their merge:
        ``serve_shard(s, qd)`` queues shard s's (ids, sims) [P, kk] for the
        chunk padded to P = pad_pow2 rows on the shard's device (an empty
        shard gives -1 / -inf), the lists go to the first device as global
        ids and merge to ``min(k, S * kk)`` columns. Returns the merged
        (gids, sims) [P, ...] device tensors; nothing here waits for the
        card on the scan's kernels."""
        from ..ops import scan as SC

        dev0 = self.devices[0]
        p_pad = SC.pad_pow2(pn)
        lists, parts = [], {}
        for s, (shard, dev) in enumerate(zip(self.shards, self.devices)):
            if shard.node_count == 0:
                lists.append(_empty_block(p_pad, kk, dev0))
                continue
            if dev not in parts:
                parts[dev] = SC.pad_queries(qds[dev][lo : lo + pn], p_pad,
                                            dev)
            with _devctx(dev):
                ids, sims = serve_shard(s, parts[dev])
            lists.append((_global(ids, s, n_pad, dev0), sims.to(dev0)))
        return _merge_topk_over(lists, self.mesh.devices.shape, k)

    def _scan_chunk(self, states, qds, lo: int, pn: int, k: int, n_pad: int,
                    *, cert: bool):
        """Queue one <= MAX_LANES chunk through every shard's scan
        (``states``: ops/scan.py ``_scan_state`` of each shard) and the
        merge: device (gids, sims, verdicts or None) of P rows.

        Each shard serves the chunk as the single index serves it: the
        exact tier (kernel A, or A′ on a hamming table), the bf16 / int8
        tier's select (kernels A-bf16 / A-int8) with an exact rescore, or
        with ``cert`` the certified tier (``scan_certified_l2``: kernel D
        in one pass, or kernels A and B; on a hamming table
        ``scan_certified_hamming``: kernels A′ and B′), whose per-shard
        verdicts are ANDed. scan-approx is the exact select, as on one
        index."""
        from ..ops import scan as SC

        oks = []
        hamming = self.config.metric == "hamming"

        def serve(s, qd):
            table, vecs, sqn, live, tscale = states[s]
            if cert:
                if hamming:
                    ids, sims, ok = SC.scan_certified_hamming(vecs, live, qd,
                                                              k=k)
                else:
                    ids, sims, ok = SC.scan_certified_l2(vecs, sqn, live, qd,
                                                         k=k)
                oks.append(ok.to(self.devices[0]))
                return ids, sims
            if hamming:
                return SC.scan_topk_exact_hamming(vecs, live, qd, k=k)
            return SC.scan_topk_exact_l2(
                vecs, sqn, live, qd, k=k,
                table=None if table is vecs else table, tscale=tscale,
            )

        gids, sims = self._merged(qds, lo, pn, k, k, n_pad, serve)
        return gids, sims, torch.stack(oks).all(0) if cert else None

    def _graph_chunk(self, snaps, qds, lo: int, pn: int, k: int, n_pad: int,
                     *, ef: int, expand: int, iters, seeds: int,
                     frontier: bool):
        """One chunk through every shard's graph beam (ops/search.py
        ``search_pipeline``: the descent, seeds, kernel C's beam and the
        exact rescore), merged: device (gids, sims). The beams wait for
        the card at every step."""
        from ..ops.search import (
            PIVOT_POOL,
            _pivot_pool,
            _seed_ids_for,
            search_pipeline,
        )

        metric = self.config.metric

        def serve(s, qd):
            snap = snaps[s]
            seed_ids = None
            if seeds > 0:
                seed_ids = _seed_ids_for(_pivot_pool(self.shards[s], snap),
                                         qd, seeds, width=PIVOT_POOL)
            return search_pipeline(
                snap.vecs, snap.sqnorms, snap.adj0, snap.adj_up,
                snap.upper_of, snap.ep, snap.max_layer, qd,
                ef=ef, k=k, metric=metric, expand=expand, iters=iters,
                nbrvec=snap.nbrvec if frontier else None,
                nbrsqn=snap.nbrsqn if frontier else None,
                seed_ids=seed_ids,
            )

        return self._merged(qds, lo, pn, min(int(k), ef), k, n_pad, serve)

    def search_batch(
        self, queries, k: int, ef_search: int | None = None,
        expand: int = 1, iters: int | None = None, engine: str = "auto",
        reply: str = "objects", seeds: int = 0,
        recall_target: float | None = None, host_qs=None,
    ):
        """Batched search across all shards; the replies and knobs of the
        single index's ``search_batch``. ``engine`` routes as there, judged
        on the largest shard's padded rows: "auto" serves every shard's
        exact scan up to SCAN_MAX_ROWS and every shard's graph beam above
        it; "scan-approx" is the approx tier. The scan takes the certified
        tier where ops/scan.py ``certified_serves`` says so, a hamming
        table without the single index's word-pack gate
        (REDIS_HNSW_TPU_SCAN_CERT=1): a query is
        certified when every shard certifies it, and the rest are served
        again through the exact sharded scan (a chunk with more than a
        quarter uncertified, whole), so replies equal the exact tier's.
        REDIS_HNSW_TPU_SCAN_DTYPE's bf16 / int8 tiers apply per shard.
        ``seeds`` > 0 seeds each shard's beam from its own pivot pool.
        With REDIS_HNSW_TPU_REPLY=ids a euclidean reply copies only its
        ids off the devices and its sims are rescored on the host from the
        shards' row tables. ``host_qs`` is accepted for parity with the
        single index and unused: sharded queries are always on the host.
        """
        from ..ops import scan as SC
        from ..ops.search import (
            SCAN_MAX_ROWS,
            coerce_queries,
            empty_reply,
            max_lanes_for,
            resolve_engine,
        )

        cfg = self.config
        engine = resolve_engine(engine, recall_target)
        if reply not in ("objects", "columnar"):
            raise ValueError(f"unknown reply mode {reply!r}")
        with profiling.span("prepare"):
            if isinstance(queries, torch.Tensor):
                queries = queries.cpu().numpy()
            vt = self.shards[0]._vectors
            qs = coerce_queries(queries, vt.dtype, vt.shape[1], cfg.metric)
            n_q = qs.shape[0]
            profiling.count("queries", n_q)
            if self.node_count == 0 or n_q == 0:
                return empty_reply(n_q, k, reply)
            snaps = [s.device_snapshot() for s in self.shards]
        n_pad = max(sn.n_pad for sn in snaps)
        use_scan = engine in ("scan", "scan-approx") or (
            engine == "auto" and n_pad <= SCAN_MAX_ROWS.get(cfg.metric, 0)
        )
        ids_mode = cfg.metric == "euclidean" and SC.reply_ids_engaged(
            cfg.dim, self.devices[0])
        want_sims = not ids_mode
        sink = None
        if use_scan:
            states = [SC._scan_state(s) for s in self.shards]
            k_eff = min(int(k), n_pad)
            # the hamming gate is the JAX package's sharded one: no word
            # pack here
            use_cert = SC.certified_serves(
                cfg.metric, n_pad, int(states[0][1].shape[1]),
                approx=engine == "scan-approx",
                tiered=any(st[0] is not st[1] for st in states),
                word_pack=False,
            )
            if use_cert:
                sink = _ShardedCertRerunSink(self, states, k_eff, n_pad)
                want_sims = True  # the reruns patch the sims too

            def serve(qds, lo, pn):
                return self._scan_chunk(states, qds, lo, pn, k_eff, n_pad,
                                        cert=use_cert)
        else:
            ef = max(cfg.ef_construction if ef_search is None
                     else int(ef_search), 1)
            seeds_eff = min(int(seeds), ef - 1) if ef > 1 else 0
            nv = [sn.nbrvec for sn in snaps]
            frontier = all(t is not None for t in nv) and (
                len({t.dtype for t in nv}) == 1)

            def serve(qds, lo, pn):
                return self._graph_chunk(
                    snaps, qds, lo, pn, k, n_pad, ef=ef, expand=expand,
                    iters=iters, seeds=seeds_eff, frontier=frontier,
                ) + (None,)

        chunk = max_lanes_for(n_pad)
        qds = self._device_queries(qs)

        def dispatch(lo):
            """Dispatch half of one chunk: every shard's kernels and the
            merge queued, the merged lists (and the ANDed verdicts)
            registered for the window's copy; the finish counts the
            certified verdicts and hands the uncertified rows to the
            sink."""
            pn = min(chunk, n_q - lo)
            gids_d, sims_d, ok_d = serve(qds, lo, pn)
            get_gids = SC.fetch_handle(gids_d[:pn])
            get_sims = SC.fetch_handle(sims_d[:pn]) if want_sims else None
            get_ok = (None if ok_d is None
                      else SC.fetch_handle(ok_d[:pn].to(torch.uint8)))

            def finish():
                gids = get_gids()
                sims = None if get_sims is None else get_sims()
                if get_ok is not None:
                    key, bad = SC.cert_fallback(get_ok() != 0, pn)
                    if key == "whole_batch_queries":
                        bad = np.arange(pn)
                    if key is not None:
                        sink.add(qs[lo : lo + pn], bad, gids, sims)
                return gids, sims

            return finish

        g_parts, s_parts = SC.drain_pipelined(
            ((lo,) for lo in range(0, n_q, chunk)), dispatch, sink=sink)
        gids = np.concatenate(g_parts)
        if ids_mode:
            # the ids-only reply: sims rescored on the host in exact direct
            # form from the shards' row tables, then the (-sim, id) order
            # re-imposed (ops/scan.py reply_ids_engaged)
            valid = gids >= 0
            v = np.zeros((*gids.shape, qs.shape[1]), np.float32)
            shard_idx = np.where(valid, gids, 0) // n_pad
            rows = np.where(valid, gids, 0) % n_pad
            for si, shard in enumerate(self.shards):
                m = valid & (shard_idx == si)
                if m.any():
                    v[m] = shard._vectors[rows[m]]
            sims = np.where(
                valid, SC.neg_sq_rows(v, qs.astype(np.float32)), NEG_INF,
            ).astype(np.float32)
            gids, sims = SC.sort_reply(gids, sims)
        else:
            sims = np.concatenate(s_parts)
        with profiling.span("assemble"):
            return self._assemble(gids, sims, n_pad, reply)

    def _assemble(self, gids, sims, n_pad: int, reply: str):
        """Columnar (names, sims) or per-query SearchResult lists from the
        merged global ids; empty slots (-1 or -inf) dropped, or None /
        -inf in the columnar form."""
        from ..ops.search import reply_objects

        sims = np.asarray(sims, np.float32)
        valid = (gids >= 0) & ~np.isneginf(sims)
        names = np.full(gids.shape, None, object)
        shard_idx, rows = gids // n_pad, gids % n_pad
        for si, shard in enumerate(self.shards):
            m = valid & (shard_idx == si)
            if m.any():
                names[m] = shard._names.names_array()[rows[m]]
        if reply == "columnar":
            return names, np.where(valid, sims, np.float32(NEG_INF))
        # The objects from the [B, k] names, slot by slot: build_reply
        # reads slot b * k + j of the flattened names, -1 where empty.
        slots = np.arange(gids.size).reshape(gids.shape)
        return reply_objects(names.reshape(-1), np.where(valid, slots, -1),
                             sims)

    # -- persistence --------------------------------------------------------

    def enable_autosave(self, directory: str, every_ops: int = 8192,
                        compress: bool = False) -> None:
        """Per-shard bounded-loss autosave into ``directory``: one npz per
        shard, the layout of :meth:`save` (restore with :meth:`restore`
        once :meth:`save` has written a manifest, or load the shards one
        by one)."""
        os.makedirs(directory, exist_ok=True)
        for s, shard in enumerate(self.shards):
            shard.enable_autosave(os.path.join(directory, f"shard{s}.npz"),
                                  every_ops=every_ops, compress=compress)

    def disable_autosave(self) -> None:
        for shard in self.shards:
            shard.disable_autosave()

    def save(self, directory: str, compress: bool = True) -> None:
        """Checkpoint the sharded index as the JAX package does: one npz
        per shard (utils/checkpoint.py) plus ``manifest.json``
        (``format_version`` 1), written last and atomically."""
        from ..convert import sharded_state
        from ..utils.checkpoint import write_state

        manifest, states = sharded_state(self)
        os.makedirs(directory, exist_ok=True)
        for s, state in enumerate(states):
            write_state(state, os.path.join(directory, f"shard{s}.npz"),
                        compress)
        tmp = os.path.join(directory, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(directory, "manifest.json"))

    @classmethod
    def restore(cls, directory: str, mesh=None,
                device=None) -> "ShardedHNSW":
        """Restore a sharded checkpoint of either package. The mesh
        (default ``make_mesh(n_shards, device)``) may order its devices
        differently but must have the checkpoint's shard count: shards are
        placed by position."""
        from ..convert import sharded_from_state
        from ..utils.checkpoint import load_state

        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        states = [
            load_state(os.path.join(directory, f"shard{s}.npz"))
            for s in range(int(manifest["n_shards"]))
        ]
        return sharded_from_state(manifest, states, mesh=mesh,
                                  device=device)
