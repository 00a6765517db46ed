"""Flat (brute-force, exact) index.

Port of ``redis_hnsw_tpu/models/flat.py``. Not present in the reference
(which only has the HNSW graph): it is the exact-kNN oracle and an index
kind of its own -- at up to millions of rows a full scan on the card is
exact and holds no graph. It serves through the same scan engine and
chunk loop as the HNSW index's scan route (ops/search.py scan_block,
ops/scan.py serve_block): the exact tier, or for euclidean
the certified-exact tier at >= 2^19 rows (for hamming the certified
hamming tier, with REDIS_HNSW_TPU_SCAN_CERT=1), and the scan-approx tier
when asked; under REDIS_HNSW_TPU_SCAN_DTYPE the bf16 tier (a bf16 copy beside
the f32 table) or the int8-resident capacity tier (only an int8 copy on
the card, candidates rescored on the host). Shares the name table and
similarity conventions of the HNSW index.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..config import IndexConfig, resolve_device
from ..errors import (
    CapacityError,
    DimensionMismatch,
    HNSWError,
    NodeExists,
    NodeNotFound,
)
from ..utils import profiling
from ..utils.names import NameTable

if TYPE_CHECKING:
    from .hnsw import SearchResult

# Rows quantized at a time by the int8-resident tier's host quantizer:
# bounds its f32 temporaries at capacity scale.
QUANT_CHUNK = 1 << 20


def quantize_rows(vecs: np.ndarray):
    """Host per-row symmetric int8 quantization of the f32 rows ``vecs``
    -> (q8 [N, D] int8, scale [N] f32), in QUANT_CHUNK-row numpy chunks:
    scale = max|v| / 127 (1 on an all-zero row), q8 = round(v / scale)
    half to even, clipped to +-127 -- the JAX package's flat quantizer
    (its models/flat.py ``_device``) byte for byte."""
    scale = np.empty(vecs.shape[0], np.float32)
    q8 = np.empty(vecs.shape, np.int8)
    for lo in range(0, vecs.shape[0], QUANT_CHUNK):
        sl = vecs[lo : lo + QUANT_CHUNK]
        amax = np.abs(sl).max(axis=1)
        sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        scale[lo : lo + QUANT_CHUNK] = sc
        q8[lo : lo + QUANT_CHUNK] = np.clip(
            np.round(sl / sc[:, None]), -127, 127
        ).astype(np.int8)
    return q8, scale


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
        self._scan_cache = None  # ((epoch, tier), scan_state())

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

    def coerce_queries(self, queries):
        """``queries`` as :meth:`search_batch` serves them (ops/search.py
        ``coerce_queries``). The table's dtype and width never change, so
        this reads nothing a write guards: callers may coerce before they
        hold the index's lock."""
        from ..ops.search import coerce_queries

        return coerce_queries(queries, self._vectors.dtype,
                              self._vectors.shape[1], self.config.metric)

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

    def scan_state(self):
        """The scan's device state of the current epoch and tier, in
        ops/scan.py ``_scan_state``'s form: a ``ScanState`` (table, vecs,
        sqn, live, tscale) with the epoch's certified fallback history.
        Rows are padded to a multiple of 128, sqnorms computed on the
        host with np.einsum (as the JAX package does, so the tables are
        byte-equal; zeros for hamming). Packed hamming words go up as
        int32, as the snapshot's do: torch has no full uint32 type.

        ``table`` is the selection table: ``vecs`` itself, or under
        REDIS_HNSW_TPU_SCAN_DTYPE=bf16 a bf16 copy built on the card. On
        the int8-RESIDENT tier (REDIS_HNSW_TPU_SCAN_DTYPE=int8 on a
        euclidean table) the f32 rows never reach the card: ``vecs`` is
        None, ``table`` the int8 copy, quantized on the host
        (:func:`quantize_rows`, its rows padded to 4 bytes), a quarter of
        the bytes, with its per-row ``tscale`` (None on the other tiers),
        and the selected candidates are rescored exactly on the host,
        where the f32 rows live. Built once per (epoch, tier), the old
        tables freed first."""
        from ..ops.cuda_scan import lowp_pad, pad_lowp_rows
        from ..ops.scan import ScanState, _to_bf16, scan_dtype
        from ..ops.snapshot import to_device

        dt = scan_dtype() if self.config.metric == "euclidean" else "f32"
        key = (self._epoch, dt)
        cached = self._scan_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        self._scan_cache = None  # free the old tables before building
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
        if dt == "int8":
            q8, scale = quantize_rows(vecs)
            pad = lowp_pad(q8.shape[1], 1)
            if pad:  # rows of 4-byte multiples, as the core reads them
                q8 = np.pad(q8, ((0, 0), (0, pad)))
            table, sqn, live, tscale = (
                to_device(a, self.device) for a in (q8, sqn, valid, scale)
            )
            vecs = None
        else:
            vecs, sqn, live = (
                to_device(a, self.device) for a in (vecs, sqn, valid)
            )
            table, tscale = vecs, None
            if dt == "bf16":
                table = pad_lowp_rows(_to_bf16(vecs))
        state = ScanState(table, vecs, sqn, live, tscale)
        self._scan_cache = (key, state)
        return state

    def _device(self):
        """The device tables as the JAX package's flat index holds them:
        (the f32 rows, or the int8-resident tier's int8 copy; sqn; live;
        tscale), from :meth:`scan_state`."""
        table, vecs, sqn, live, tscale = self.scan_state()
        return (table if vecs is None else vecs, sqn, live, tscale)

    def search_batch(
        self, queries, k: int, use_pallas: bool = False,
        approx: bool = False, recall_target: float | None = None,
        host_qs=None, reply: str = "objects",
    ) -> list[list[SearchResult]]:
        """Batched exact k-NN. ``use_pallas=True`` runs the exact tier
        (kernel A, or A′ for hamming) over the whole query block at once,
        the port of the JAX package's fused Pallas scan path;
        the default serves through the scan engine's chunk loop
        (ops/search.py ``scan_block``), on the certified tier where
        ops/scan.py ``certified_serves`` says so: at >= 2^19 euclidean
        rows, and on a hamming table where REDIS_HNSW_TPU_SCAN_CERT=1
        and the word-pack gate admit it. ``approx``, and
        a ``recall_target`` at or below the approx tier's floor, ask for
        the scan-approx tier (ops/scan.py serve_block).
        REDIS_HNSW_TPU_SCAN_DTYPE=bf16 selects on a bf16 copy of the
        table (kernel A-bf16) and rescores exactly on the card; ``int8``
        serves the int8-resident tier (ops/scan.py serve_resident_int8:
        kernel A-int8 selects ``INT8_RESCORE * k`` candidates, rescored
        exactly on the host against ``host_qs``, the host mirror of
        device-resident ``queries``, or the queries copied back). Under
        int8, ``use_pallas=True`` serves that tier too: the JAX package
        scores the int8 table as f32 rows there (ROADMAP.md section 3).
        A flat reply carries its sims whatever REDIS_HNSW_TPU_REPLY says,
        as in the JAX package. ``reply="columnar"`` returns the (names,
        sims) array pair."""
        from ..ops import scan as SC
        from ..ops.search import (
            assemble,
            empty_reply,
            resolve_engine,
            scan_block,
        )

        if reply not in ("objects", "columnar"):
            raise ValueError(f"unknown reply mode {reply!r}")
        if recall_target is not None:
            approx = approx or (
                resolve_engine("auto", recall_target) == "scan-approx"
            )
        with profiling.span("prepare"):
            qs = self.coerce_queries(queries)
            profiling.count("queries", qs.shape[0])
            if self.node_count == 0:
                return empty_reply(qs.shape[0], k, reply)
            state = self.scan_state()
        _, vecs, sqn, valid, tscale = state
        metric = self.config.metric
        n_q = qs.shape[0]
        if n_q == 0:
            ids = np.empty((0, int(k)), np.int32)
            sims = np.empty((0, int(k)), np.float32)
        elif use_pallas and tscale is None:
            k_eff = min(int(k), int(vecs.shape[0]))
            profiling.count("chunks", 1)
            profiling.count("exact_queries", n_q)
            with profiling.span("dispatch"):
                qd = SC.pad_queries(qs, n_q, vecs.device)
                if metric == "hamming":
                    ids, sims = SC.scan_topk_exact_hamming(vecs, valid, qd,
                                                           k=k_eff)
                else:
                    ids, sims = SC.scan_topk_exact_l2(vecs, sqn, valid, qd,
                                                      k=k_eff)
            with profiling.span("card_wait"):
                ids, sims = ids.cpu().numpy(), sims.cpu().numpy()
        else:
            ids, sims = scan_block(
                state, qs, k, metric=metric, approx=approx,
                host_qs=host_qs if isinstance(qs, torch.Tensor) else qs,
                host_vecs=self._vectors,
            )
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
