"""Dense device-resident snapshots of an index.

Port of ``redis_hnsw_tpu/ops/snapshot.py``: the bridge between the
host-authoritative graph (models/hnsw.py or the native C++ core) and the
batched device search. The pointer graph is flattened into fixed-shape
int32 adjacency tables plus the f32 vector table, as torch tensors on the
index's device, and reused across queries. This replaces the reference's
``make_index`` 3-pass pointer-graph rehydration (src/lib.rs:252-315) with
dense array uploads -- there is nothing to rewire when rows are ids.

Layout (the same tables, shapes and padding as the JAX package, so the two
snapshots of one index are byte-equal):

* ``vecs [N_pad, D]`` + ``sqnorms [N_pad]`` -- vector table (f32) or packed
  bits (uint32 rows stored as int32, Hamming; sqnorms zero).
* ``adj0 [N_pad, deg0]`` -- layer-0 adjacency, -1 padded
  (deg0 >= m_max_0 = 2m, core.rs:336).
* ``adj_up [L_up, U_pad, degU]`` -- upper-layer adjacency over a *compact*
  slot space holding only the ~N/m rows whose level >= 1. Slots are
  assigned stably at insertion (models/hnsw.py ``_upper_slot``) so
  incremental updates never reshuffle the table.
* ``upper_of [N_pad]`` -- global row -> compact upper slot (-1 if level 0).
* ``ep``, ``max_layer`` -- entry point and top layer, host ints.

The graph beam's frontier tables, chosen per snapshot by the JAX
package's own tier rule (:func:`_use_quant`, :func:`_nbrvec_dtype`):

* ``nbrvec [N_pad, deg0, D]`` -- every node's neighbour vectors stored
  contiguously (``nbrvec[x] = vecs[adj0[x]]``), f32, f16 or bf16, with
  ``nbrsqn [N_pad, deg0]`` their exact f32 sqnorms: the beam scores a
  candidate's whole neighbourhood from one block (kernel C,
  ops/cuda_gather.py);
* the int8 block tier: int8 ``nbrvec`` and ``nbrsqn [N_pad, 2*deg0]``
  holding each neighbour's (dequant scale, exact sqnorm);
* ``qrows [N_pad, D+8]`` -- the high-D tier: int8 rows with the f32
  (scale, sqnorm) pair in their last 8 bytes;
* none of them (``REDIS_HNSW_TPU_NBRVEC_DTYPE=off`` or over budget): the
  beam gathers rows.

Refresh strategy: a full rebuild uploads everything. When the padded
shapes are unchanged, ``build_snapshot(prev=...)`` applies a **dirty-row
delta** instead: only rows whose adjacency or vector changed since the
last snapshot are copied into the previous tensors, in place. When the
new vectors are exactly a bulk-build wave's rows, they are copied from
the wave's query block, already on the card (ops/construct.py
``complete_wave``), instead of uploaded (``snapshot_refreshes``
counts these deltas as ``delta_device``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from . import distance as D


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_pow2(x: int, lo: int) -> int:
    """Next power of two >= max(x, lo): geometric snapshot growth keeps
    table shapes stable across mutations (a full rebuild only on
    doubling), at <=2x memory overhead on the padded tables."""
    p = lo
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Device view of one index epoch.

    Lifetime contract: the incremental refresh (``_apply_delta``) writes
    the dirty rows INTO the previous snapshot's tensors, so a Snapshot
    obtained from ``device_snapshot()`` changes under the next mutation +
    snapshot of the same index. Do not cache a Snapshot across writes;
    re-fetch via ``device_snapshot()`` each time (it is epoch-cached and
    free when nothing changed)."""

    vecs: torch.Tensor      # [N_pad, D] f32 (int32-stored packed bits)
    sqnorms: torch.Tensor   # [N_pad] f32 (zeros for hamming)
    adj0: torch.Tensor      # [N_pad, deg0] int32, -1 padded
    adj_up: torch.Tensor    # [L_up, U_pad, degU] int32, -1 padded
    upper_of: torch.Tensor  # [N_pad] int32, -1 if level < 1
    ep: int
    max_layer: int
    metric: str
    n_pad: int              # row capacity
    # Row high-water mark AT BUILD TIME: rows >= live_hw were allocated
    # after this snapshot and hold no data here. Bounded-staleness
    # serving (device_snapshot(max_staleness=...)) masks them dead so a
    # stale view never scores uninitialized vectors.
    live_hw: int = 0
    # Graph-beam frontier tiers (module docstring); None when absent.
    nbrvec: torch.Tensor | None = None   # [N_pad, deg0, D]
    nbrsqn: torch.Tensor | None = None   # [N_pad, deg0] or [N_pad, 2*deg0]
    qrows: torch.Tensor | None = None    # [N_pad, D+8] int8


def _shapes(index):
    """Padded table shapes for the index's current state + hints."""
    cfg = index.config
    hint = int(getattr(index, "_capacity_hint", 0))
    n_rows = max(index._names.high_water, 1)
    if hint >= n_rows and hint > 0:
        # Hint-exact rows: presized configs declare the final size up
        # front, so pad to the hint rounded to 128 rows instead of the
        # next power of two (pow2 padding wastes up to 2x memory).
        # Shapes stay stable because the hint is fixed; the sticky-dims
        # no-shrink rule in build_snapshot guards against flip-flops.
        n_pad = _round_up(max(n_rows, hint), 128)
    else:
        # no (or stale) hint: geometric growth keeps incremental
        # add_node from rebuilding every 128 rows
        n_pad = _round_pow2(n_rows, 128)

    native = index._native
    max0 = cfg.m_max_0
    max_up = cfg.m_max
    # Degree can transiently exceed the caps after delete repair (the
    # reference's repair adds extension links without a shrink pass,
    # core.rs:824-863) -- size columns to the observed max.
    if native is not None:
        max0 = max(max0, native.max_degree(0, n_rows))
        for lc in range(1, max(int(index.max_layer), 1) + 1):
            max_up = max(max_up, native.max_degree(lc, n_rows))
    else:
        for row in range(n_rows):
            lists = index._neighbors[row]
            if lists is None:
                continue
            if lists and len(lists[0]) > max0:
                max0 = len(lists[0])
            for lc in range(1, len(lists)):
                if len(lists[lc]) > max_up:
                    max_up = len(lists[lc])
    deg0 = _round_up(max0, 8)
    deg_up = _round_up(max_up, 8)

    # Upper stack: presize depth to the expected max level for ``hint``
    # rows (P(level >= L) ~ m^-L) and width to the expected upper count
    # (~hint/m) so neither grows mid-build.
    l_hint = 0
    u_hint = 1
    if hint > 1:
        l_hint = int(math.ceil(math.log(hint) / math.log(max(cfg.m, 2)))) + 1
        u_hint = int(1.2 * hint / max(cfg.m, 2)) + 8
    l_up = max(int(index.max_layer), 1, l_hint)
    u_pad = _round_pow2(max(index._upper_next, u_hint), 8)
    return n_rows, n_pad, deg0, deg_up, l_up, u_pad


def _row_adj(index, rows, lc, deg):
    """Dense [-1 padded] adjacency block for given rows at one layer."""
    native = index._native
    if native is not None:
        return native.export_layer(lc, rows, len(rows), deg)
    out = np.full((len(rows), deg), -1, np.int32)
    for i, row in enumerate(rows):
        lists = index._neighbors[row]
        if lists and lc < len(lists) and lists[lc]:
            out[i, : len(lists[lc])] = lists[lc]
    return out


def _phys_block_bytes(n, f, d, itemsize: int) -> int:
    """Bytes of an [n, f, d] block table as the JAX package budgets them:
    its TPU tiling pads the minor dim to 128 lanes and the second-minor
    to the dtype's sublane count. The port keeps that reckoning, so one
    index gets the same tier in both packages (whether the budget should
    follow the H100's own layout is an open question in ROADMAP.md)."""
    sublane = {1: 32, 2: 16, 4: 8}[itemsize]
    return n * _round_up(f, sublane) * _round_up(d, 128) * itemsize


_NBRVEC_FORCED = {
    "f32": torch.float32, "f16": torch.float16,
    "bf16": torch.bfloat16, "i8": torch.int8,
}


def _nbrvec_dtype(metric, n_pad, deg0, width):
    """Element type of the neighbour blocks, or None for row gathers --
    the JAX package's rule. ``REDIS_HNSW_TPU_NBRVEC_DTYPE`` forces one
    (f32, f16, bf16, i8, off); otherwise the widest type whose table fits
    ``REDIS_HNSW_TPU_NBRVEC_BYTES`` (default 9 GiB, tile-padded bytes):
    f32, then f16, then int8 blocks plus their [N, 2F] f32 meta. Hamming
    blocks are the packed words themselves (int32 here)."""
    forced = os.environ.get("REDIS_HNSW_TPU_NBRVEC_DTYPE")
    if forced:
        if forced == "off":
            return None
        if metric == "hamming":
            return torch.int32
        return _NBRVEC_FORCED[forced]
    budget = int(os.environ.get("REDIS_HNSW_TPU_NBRVEC_BYTES", 9 * 2**30))
    if metric == "hamming":
        phys = _phys_block_bytes(n_pad, deg0, width, 4)
        return torch.int32 if phys <= budget else None
    if _phys_block_bytes(n_pad, deg0, width, 4) <= budget:
        return torch.float32
    if _phys_block_bytes(n_pad, deg0, width, 2) <= budget:
        # f16, not bf16: within dense clusters neighbour-sim gaps are
        # smaller than bf16's 8-bit-mantissa error on large sims
        return torch.float16
    if (
        _phys_block_bytes(n_pad, deg0, width, 1)
        + n_pad * _round_up(2 * deg0, 128) * 4  # [N, 2F] f32 meta
        <= budget
    ):
        return torch.int8
    return None


# Above this row width the euclidean snapshot carries the int8 row table
# (qrows) for beam routing instead of blocks. REDIS_HNSW_TPU_QUANT=0
# disables; =1 forces at any width.
QUANT_MIN_DIM = 512


def _use_quant(metric: str, width: int) -> bool:
    flag = os.environ.get("REDIS_HNSW_TPU_QUANT")
    if flag == "0" or metric != "euclidean":
        return False
    return flag == "1" or width >= QUANT_MIN_DIM


def _quantize_split(vecs: torch.Tensor):
    """Per-row symmetric int8 quantization: (x8, scale) as separate
    tensors (the int8 block tier keeps the scales in ``nbrsqn``)."""
    scale = D.quant_scale(vecs)
    x8 = torch.clamp(torch.round(vecs / scale[..., None]), -127, 127)
    return x8.to(torch.int8), scale


def _quantize_rows(vecs: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """Per-row int8 quantization packed as [..., D+8] int8: the x8
    columns, then the bytes of the f32 (dequant scale, exact sqnorm)
    pair, so one row gather carries vector and scalars."""
    x8, scale = _quantize_split(vecs)
    meta = torch.stack([scale, sq.float()], dim=-1).contiguous()
    return torch.cat([x8, meta.view(torch.int8)], dim=-1)


def _narrow_rows(vecs: torch.Tensor, dtype) -> torch.Tensor:
    """The row table in the block element type, narrowed BEFORE the
    gather (gather-then-narrow would hold a full-width [N, F, D]
    intermediate: 16 GiB in f32 at 1M rows)."""
    if dtype == torch.int8:
        return _quantize_split(vecs)[0]
    return vecs.to(dtype)


def _gather_blocks(rows: torch.Tensor, adj0: torch.Tensor) -> torch.Tensor:
    return rows[adj0.clamp(min=0).long()]


def _gather_meta(vecs, sq, adj0):
    """[N, 2F] f32 per-neighbour meta of the int8 tier: columns [:F] are
    dequant scales, [F:] exact sqnorms."""
    safe = adj0.clamp(min=0).long()
    return torch.cat([D.quant_scale(vecs)[safe], sq[safe]], dim=1)


def _build_nbrvec(vecs, sq, adj0, *, dtype):
    """(nbrvec, nbrsqn) on the tables' device: one [N*deg0]-row gather
    from the already-uploaded row table, narrowed first."""
    blocks = _gather_blocks(_narrow_rows(vecs, dtype), adj0)
    if dtype == torch.int8:
        return blocks, _gather_meta(vecs, sq, adj0)
    return blocks, _gather_blocks(sq, adj0)


def _sqnorms_np(index, vec_rows):
    """Row sqnorms on the host (np.einsum, as the JAX package computes
    them), so the table is bit-identical to the JAX snapshot's and a
    delta's rows to a full rebuild's."""
    if index.config.metric == "hamming":
        return np.zeros(len(vec_rows), np.float32)
    return np.einsum("nd,nd->n", vec_rows, vec_rows).astype(np.float32)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype == np.uint32:
        # torch has no full uint32 support: packed bits ride as int32
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def build_snapshot(index, prev: Snapshot | None = None) -> Snapshot:
    """Flatten a host HNSWIndex into a Snapshot on ``index.device``.

    With ``prev`` whose shapes still fit, only dirty rows are copied
    into the previous tensors (delta refresh); otherwise a full rebuild
    uploads everything.
    """
    cfg = index.config
    dev = index.device
    n_rows, n_pad, deg0, deg_up, l_up, u_pad = _shapes(index)
    if prev is not None and prev.metric == cfg.metric:
        # sticky dims: observed max degree can shrink again after repair
        # (links over the cap get pruned) -- never shrink the padded
        # tables or shapes flip-flop and every refresh rebuilds
        n_pad = max(n_pad, prev.n_pad)
        deg0 = max(deg0, prev.adj0.shape[1])
        l_up = max(l_up, prev.adj_up.shape[0])
        u_pad = max(u_pad, prev.adj_up.shape[1])
        deg_up = max(deg_up, prev.adj_up.shape[2])

    width = index._vectors.shape[1]
    use_q = _use_quant(cfg.metric, width)
    nv_dtype = None if use_q else _nbrvec_dtype(cfg.metric, n_pad, deg0, width)
    if (
        prev is not None
        and prev.metric == cfg.metric
        and prev.n_pad == n_pad
        and prev.adj0.shape[1] == deg0
        and tuple(prev.adj_up.shape) == (l_up, u_pad, deg_up)
        and (None if prev.nbrvec is None else prev.nbrvec.dtype) == nv_dtype
        and (prev.qrows is not None) == use_q
    ):
        index.snapshot_refreshes["delta"] += 1
        return _delta_snapshot(index, prev)
    index.snapshot_refreshes["full"] += 1

    # full rebuild covers everything: discard pending delta state
    index.drain_dirty()
    index._dirty_vec.clear()
    index._freed_slots_pending = []
    index._pending_wave_vecs = None

    vecs = np.zeros((n_pad, index._vectors.shape[1]), index._vectors.dtype)
    vecs[:n_rows] = index._vectors[:n_rows]
    all_rows = np.arange(n_rows, dtype=np.int32)
    adj0 = np.full((n_pad, deg0), -1, np.int32)
    adj0[:n_rows] = _row_adj(index, all_rows, 0, deg0)

    adj_up = np.full((l_up, u_pad, deg_up), -1, np.int32)
    upper_of = np.full(n_pad, -1, np.int32)
    if index._upper_slot:
        up_rows = np.fromiter(
            index._upper_slot.keys(), np.int32, len(index._upper_slot)
        )
        up_slots = np.fromiter(
            index._upper_slot.values(), np.int32, len(index._upper_slot)
        )
        upper_of[up_rows] = up_slots
        for lc in range(1, int(index.max_layer) + 1):
            adj_up[lc - 1, up_slots] = _row_adj(index, up_rows, lc, deg_up)

    sq = np.zeros(n_pad, np.float32)
    sq[:n_rows] = _sqnorms_np(index, vecs[:n_rows])

    vecs_d = to_device(vecs, dev)
    sq_d = to_device(sq, dev)
    adj0_d = to_device(adj0, dev)
    nbrvec = nbrsqn = qrows = None
    if nv_dtype is not None:
        nbrvec, nbrsqn = _build_nbrvec(vecs_d, sq_d, adj0_d, dtype=nv_dtype)
    if use_q:
        qrows = _quantize_rows(vecs_d, sq_d)
    return Snapshot(
        vecs=vecs_d,
        sqnorms=sq_d,
        adj0=adj0_d,
        adj_up=to_device(adj_up, dev),
        upper_of=to_device(upper_of, dev),
        ep=max(int(index.enterpoint), 0),
        max_layer=int(index.max_layer),
        metric=cfg.metric,
        n_pad=n_pad,
        live_hw=int(index._names.high_water),
        nbrvec=nbrvec,
        nbrsqn=nbrsqn,
        qrows=qrows,
    )


def _apply_delta(prev: Snapshot, vrows, vec_data, sq_data, arows,
                 adj0_data, upof_vals, wipe_flat, up_flat, up_data):
    """Apply a whole dirty-row delta to ``prev``'s tensors, IN PLACE
    (row copies; no table is reallocated -- the JAX package gets the
    same effect by donating the buffers to its update program).
    ``vec_data`` is a host array, or the device block of a wave's rows.

    Ordering invariant: the freed-slot wipe runs BEFORE the upper-row
    copy (a freed slot reallocated to a dirty row must keep the fresh
    adjacency).

    The frontier tiers are refreshed from the UPDATED vecs/sqnorms: the
    quantized rows of every new vector, and the neighbour blocks of
    exactly the dirty adjacency rows. That covers every stale block: a
    block changes only when its row's adjacency does (linking dirties
    both endpoints), and a freed row is unlinked from every live
    adjacency by delete repair (dirtying the referrers) before its slot
    can be reused."""
    dev = prev.vecs.device
    if len(vrows):
        idx = torch.from_numpy(vrows).to(dev)
        vec_d = (vec_data if isinstance(vec_data, torch.Tensor)
                 else to_device(vec_data, dev))
        sq_d = to_device(sq_data, dev)
        prev.vecs.index_copy_(0, idx, vec_d)
        prev.sqnorms[idx] = sq_d
        if prev.qrows is not None:
            prev.qrows[idx] = _quantize_rows(vec_d, sq_d)
    if len(arows):
        idx = torch.from_numpy(arows.astype(np.int64)).to(dev)
        adj_d = to_device(adj0_data, dev)
        prev.adj0[idx] = adj_d
        prev.upper_of[idx] = to_device(upof_vals, dev)
        if prev.nbrvec is not None:
            # narrowing is per row, so narrowing the gathered rows
            # gives the full build's narrow-then-gather bits
            prev.nbrvec[idx] = _narrow_rows(
                _gather_blocks(prev.vecs, adj_d), prev.nbrvec.dtype
            )
            if prev.nbrvec.dtype == torch.int8:
                prev.nbrsqn[idx] = _gather_meta(prev.vecs, prev.sqnorms, adj_d)
            else:
                prev.nbrsqn[idx] = _gather_blocks(prev.sqnorms, adj_d)
    flat_up = prev.adj_up.view(-1, prev.adj_up.shape[2])
    if len(wipe_flat):
        flat_up[torch.from_numpy(wipe_flat).to(dev)] = -1
    if len(up_flat):
        flat_up[torch.from_numpy(up_flat).to(dev)] = to_device(up_data, dev)


def _delta_snapshot(index, prev: Snapshot) -> Snapshot:
    """Copy all dirty rows (vectors, sqnorms, layer-0 adjacency, upper
    adjacency, slot map, freed-slot wipes) into the previous tensors."""
    dirty = np.unique(index.drain_dirty())
    vec_new = index._dirty_vec
    index._dirty_vec = set()
    deg0 = prev.adj0.shape[1]
    deg_up = prev.adj_up.shape[2]
    u_pad = prev.adj_up.shape[1]

    # -- vector updates ------------------------------------------------
    pending = getattr(index, "_pending_wave_vecs", None)
    index._pending_wave_vecs = None
    if pending is not None and vec_new == {int(r) for r in pending[0]}:
        # the new vectors are exactly a wave's rows, already on the card
        # as its queries (ops/construct.py complete_wave), and no row was
        # allocated since (models/hnsw.py _alloc_row drops the block):
        # copy them from there, in wave order
        vrows = pending[0].astype(np.int64)
        vec_data = pending[1]
        index.snapshot_refreshes["delta_device"] += 1
    else:
        vrows = np.fromiter(sorted(vec_new), np.int64, len(vec_new))
        vec_data = index._vectors[vrows]
    # sqnorms host-side so they are bit-identical to a full rebuild's
    sq_data = _sqnorms_np(index, index._vectors[vrows])

    # -- layer-0 adjacency + slot map over dirty rows --------------------
    arows = dirty.astype(np.int32)
    adj0_data = _row_adj(index, arows, 0, deg0)
    upof_vals = np.array(
        [index._upper_slot.get(int(r), -1) for r in arows], np.int32
    )

    # -- freed upper slots: wipe rows at EVERY layer ---------------------
    freed = index._freed_slots_pending
    index._freed_slots_pending = []
    n_layers_tot = prev.adj_up.shape[0]
    wipe_flat = np.zeros(0, np.int64)
    if freed:
        fr = np.asarray(freed, np.int64)
        wipe_flat = (
            np.arange(n_layers_tot, dtype=np.int64)[:, None] * u_pad
            + fr[None, :]
        ).ravel()

    # -- upper adjacency rows (flat (layer, slot) space) ------------------
    has_up = upof_vals >= 0
    up_flat = np.zeros(0, np.int64)
    up_data = np.zeros((0, deg_up), np.int32)
    n_l = int(index.max_layer)
    if has_up.any() and n_l > 0:
        up_rows = arows[has_up]
        up_slots = upof_vals[has_up].astype(np.int64)
        up_flat = (
            np.arange(n_l, dtype=np.int64)[:, None] * u_pad
            + up_slots[None, :]
        ).ravel()
        up_data = np.concatenate(
            [_row_adj(index, up_rows, lc, deg_up) for lc in range(1, n_l + 1)],
            axis=0,
        )

    _apply_delta(prev, vrows, vec_data, sq_data, arows, adj0_data,
                 upof_vals, wipe_flat, up_flat, up_data)
    return dataclasses.replace(
        prev,
        ep=max(int(index.enterpoint), 0),
        max_layer=int(index.max_layer),
        live_hw=int(index._names.high_water),
    )
