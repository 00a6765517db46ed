"""Flat (brute-force, exact) index.

Port of ``redis_hnsw_tpu/models/flat.py`` (euclidean f32 and hamming).
Not present in the reference (which only has the HNSW graph): it is the
exact-kNN oracle and an index kind of its own -- at up to millions of rows
a full scan on the card is exact and holds no graph. It serves through the
same scan engine as the HNSW index (ops/scan.py serve_block): the exact
tier, or for euclidean the certified-exact tier at >= 2^19 rows, and the
scan-approx tier when asked. Shares
the name table and similarity conventions of the HNSW index.
"""

from __future__ import annotations

import numpy as np

from ..config import IndexConfig, resolve_device
from ..errors import (
    CapacityError,
    DimensionMismatch,
    HNSWError,
    NodeExists,
    NodeNotFound,
)
from ..utils.names import NameTable
from .hnsw import SearchResult


class FlatIndex:
    def __init__(self, name: str, config: IndexConfig, device=None) -> None:
        self.name = name
        self.config = config
        self.device = resolve_device(device)
        width = (
            config.dim // 32 if config.metric == "hamming" else config.dim
        )
        dtype = np.uint32 if config.metric == "hamming" else np.float32
        cap = max(int(config.capacity), 8)
        self._vectors = np.zeros((cap, width), dtype)
        self._valid = np.zeros(cap, bool)
        self._names = NameTable()
        self._epoch = 0
        self._dev = None
        self._dev_epoch = -1

    @property
    def node_count(self) -> int:
        return len(self._names)

    def info(self) -> dict:
        """HNSW.GET reply with the reference's full 9-field shape
        (src/types.rs:122-155). The flat kind has no graph, so the
        graph-only fields (m, ef_construction, level_mult, max_layer,
        enterpoint) are honest nulls rather than absent keys."""
        return {
            "name": self.name,
            "metric": self.config.metric.capitalize(),
            "data_dim": self.config.dim,
            "m": None,
            "ef_construction": None,
            "level_mult": None,
            "node_count": self.node_count,
            "max_layer": None,
            "enterpoint": None,
        }

    def __len__(self) -> int:
        return self.node_count

    def _coerce(self, data) -> np.ndarray:
        arr = np.asarray(data, dtype=self._vectors.dtype).ravel()
        got = arr.size * (32 if self.config.metric == "hamming" else 1)
        if got != self.config.dim:
            raise DimensionMismatch(got)
        return arr

    def add_node(self, name: str, data) -> None:
        if not name:
            raise HNSWError("node name must be non-empty")
        if name in self._names:
            raise NodeExists(name)
        q = self._coerce(data)
        row = self._names.alloc(name)
        if row >= self._vectors.shape[0]:
            if self.config.fixed_capacity:
                self._names.free(name)
                raise CapacityError(
                    f"index at fixed capacity {self.config.capacity} "
                    f"(need {row + 1} rows)"
                )
            new_cap = max(self._vectors.shape[0] * 2, row + 1)
            vecs = np.zeros((new_cap, self._vectors.shape[1]), q.dtype)
            vecs[: self._vectors.shape[0]] = self._vectors
            valid = np.zeros(new_cap, bool)
            valid[: self._valid.shape[0]] = self._valid
            self._vectors, self._valid = vecs, valid
        self._vectors[row] = q
        self._valid[row] = True
        self._epoch += 1

    def add_batch(self, names, data) -> None:
        data = np.atleast_2d(np.asarray(data, dtype=self._vectors.dtype))
        names = list(names)
        if len(names) != data.shape[0]:
            raise ValueError(
                f"{len(names)} names for {data.shape[0]} data rows"
            )
        if data.shape[1] != self._vectors.shape[1]:
            got = data.shape[1] * (
                32 if self.config.metric == "hamming" else 1
            )
            raise DimensionMismatch(got)
        seen: set[str] = set()
        for n in names:
            if not n:
                raise HNSWError("node name must be non-empty")
            if n in self._names or n in seen:
                raise NodeExists(n)
            seen.add(n)
        rows = np.fromiter(
            (self._names.alloc(n) for n in names), np.int64, len(names)
        )
        need = int(rows.max(initial=-1)) + 1
        if need > self._vectors.shape[0]:
            if self.config.fixed_capacity:
                for n in names:
                    self._names.free(n)
                raise CapacityError(
                    f"index at fixed capacity {self.config.capacity} "
                    f"(need {need} rows)"
                )
            new_cap = self._vectors.shape[0]
            while new_cap < need:
                new_cap *= 2
            vecs = np.zeros((new_cap, self._vectors.shape[1]), data.dtype)
            vecs[: self._vectors.shape[0]] = self._vectors
            valid = np.zeros(new_cap, bool)
            valid[: self._valid.shape[0]] = self._valid
            self._vectors, self._valid = vecs, valid
        self._vectors[rows] = data
        self._valid[rows] = True
        self._epoch += 1

    def delete_node(self, name: str) -> None:
        if name not in self._names:
            raise NodeNotFound(name)
        row = self._names.free(name)
        self._valid[row] = False
        self._epoch += 1

    def delete_batch(self, names) -> None:
        """Bulk delete: validate-all-first (nothing mutates on error),
        then one epoch bump for the whole batch."""
        names = list(names)
        seen: set[str] = set()
        for n in names:
            if n not in self._names or n in seen:
                raise NodeNotFound(n)
            seen.add(n)
        if not names:
            return
        for n in names:
            self._valid[self._names.free(n)] = False
        self._epoch += 1

    def _device(self):
        """Device tables (vecs, sqn, valid) of the current epoch: rows
        padded to a multiple of 128, sqnorms computed on the host with
        np.einsum (as the JAX package does, so the tables are
        byte-equal; zeros for hamming). Packed hamming words go up as
        int32, as the snapshot's do: torch has no full uint32 type."""
        from ..ops.scan import scan_dtype
        from ..ops.snapshot import to_device

        scan_dtype(self.config.metric)
        if self._dev is None or self._dev_epoch != self._epoch:
            n = max(self._names.high_water, 1)
            n_pad = ((n + 127) // 128) * 128
            if self._vectors.shape[0] == n_pad:
                vecs = self._vectors
            else:
                vecs = np.zeros(
                    (n_pad, self._vectors.shape[1]), self._vectors.dtype
                )
                vecs[:n] = self._vectors[:n]
            valid = np.zeros(n_pad, bool)
            valid[:n] = self._valid[:n]
            if self.config.metric == "hamming":
                sqn = np.zeros(n_pad, np.float32)
            else:
                sqn = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
            self._dev = None  # free the old tables before the upload
            self._dev = tuple(
                to_device(a, self.device) for a in (vecs, sqn, valid)
            )
            self._dev_epoch = self._epoch
        return self._dev

    def search_batch(
        self, queries, k: int, use_pallas: bool = False,
        approx: bool = False, recall_target: float | None = None,
        host_qs=None, reply: str = "objects",
    ) -> list[list[SearchResult]]:
        """Batched exact k-NN. ``use_pallas=True`` runs the exact tier
        (kernel A, or A′ for hamming) over the whole query block at once,
        the port of the JAX package's fused Pallas scan path;
        the default serves through the scan engine in 2048-query chunks,
        on the certified tier at >= 2^19 euclidean rows. ``approx``, and
        a ``recall_target`` at or below the approx tier's floor, ask for
        the scan-approx tier (ops/scan.py serve_block). ``host_qs`` is
        taken for the JAX package's signature; its only reader there is
        the int8-resident tier (ROADMAP queue 1 item 9), and a flat reply
        carries its sims whatever REDIS_HNSW_TPU_REPLY says, as in the
        JAX package. ``reply="columnar"`` returns the (names, sims) array
        pair."""
        from ..ops import scan as SC
        from ..ops.search import (
            MAX_LANES,
            assemble,
            coerce_queries,
            empty_reply,
            resolve_engine,
        )

        if reply not in ("objects", "columnar"):
            raise ValueError(f"unknown reply mode {reply!r}")
        if recall_target is not None:
            approx = approx or (
                resolve_engine("auto", recall_target) == "scan-approx"
            )
        qs = coerce_queries(
            queries, self._vectors.dtype, self._vectors.shape[1],
            self.config.metric,
        )
        if self.node_count == 0:
            return empty_reply(qs.shape[0], k, reply)
        metric = self.config.metric
        vecs, sqn, valid = self._device()
        k_eff = min(int(k), int(vecs.shape[0]))
        n_q = qs.shape[0]
        if n_q == 0:
            ids = np.empty((0, int(k)), np.int32)
            sims = np.empty((0, int(k)), np.float32)
        elif use_pallas:
            qd = SC.pad_queries(qs, n_q, vecs.device)
            if metric == "hamming":
                ids, sims = SC.scan_topk_exact_hamming(vecs, valid, qd,
                                                       k=k_eff)
            else:
                ids, sims = SC.scan_topk_exact_l2(vecs, sqn, valid, qd,
                                                  k=k_eff)
            ids, sims = ids.cpu().numpy(), sims.cpu().numpy()
        else:
            sink = SC.CertRerunSink()
            qd = qs
            if n_q > MAX_LANES:
                # one host->device copy for the whole block
                qd = SC.pad_queries(qs, n_q, vecs.device)
            parts = []
            for lo in range(0, n_q, MAX_LANES):
                part = qd[lo : lo + MAX_LANES]
                n_part = int(part.shape[0])
                parts.append(SC.serve_block(
                    vecs, sqn, valid,
                    SC.pad_queries(part, SC.pad_pow2(n_part), vecs.device),
                    k=k_eff, n_q=n_part, metric=metric, rerun_sink=sink,
                    approx=approx,
                ))
            sink.flush()  # patches the parts' rows in place
            ids = np.concatenate([p[0] for p in parts])
            sims = np.concatenate([p[1] for p in parts])
        return assemble(self._names.names_array(), ids, sims, reply)

    def search_knn(self, data, k: int) -> list[SearchResult]:
        res = self.search_batch(np.atleast_2d(self._coerce(data)), k)[0]
        # single-query replies carry the vector, like HNSWIndex.search_knn
        for r in res:
            r.data = self._vectors[self._names.get(r.name)].copy()
        return res

    def get_node(self, name: str) -> dict:
        """HNSW.NODE.GET parity for the flat kind: data + (no) neighbors."""
        row = self._names.get(name)
        if row is None:
            raise NodeNotFound(name)
        return {"data": self._vectors[row].copy(), "neighbors": []}
