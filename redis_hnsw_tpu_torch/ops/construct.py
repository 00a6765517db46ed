"""Batched index construction: the bulk-build engine.

Port of ``redis_hnsw_tpu/ops/construct.py``. The reference inserts one
node at a time (src/hnsw/core.rs:489-599): per insert, a greedy descent
and an ef_construction-wide beam per layer. Candidate discovery
vectorizes across an insert *wave*: one device pass runs the descent and
every layer's beam for W inserts at once (masked by each insert's sampled
level). The graph surgery (top-m link selection, bidirectional connect,
degree shrink -- core.rs:523-577) is pointer work applied on the host in
insertion order, by the native core (``hnsw_apply_wave``) or in Python,
with the same result.

Approximations relative to the sequential build (the exact path remains
``HNSWIndex.add_node``), as in the JAX package:

* Beams see the graph as of the wave start; nodes inserted earlier in the
  same wave are candidates through exact intra-wave sims, but their links
  are not traversed until the next wave.
* ``select_neighbors``'s candidate extension (core.rs:689-722) is skipped.

Layer-0 candidates come from one of two sources (:func:`_build_l0_scan`):
the exact scan (kernel A at k = ``fetch_c``, "scan-l0", the default for
euclidean builds up to ``SCAN_MAX_ROWS`` rows) or the ef-wide beam
(kernel C's block form on the f32/f16/bf16 frontier tiers). Upper-layer
hill climbs and beams score rows through kernel C's row form on the card.
On the CPU the plain versions run.

Where the port departs from the JAX code: the JAX package runs a
``lax.scan`` over the whole padded layer stack so that one compile serves
a build; here a Python loop runs only the layers that exist
(``max_layer``) and fills the rest of the packed buffer as the scan's
masked steps leave it, so the buffer is the same.

A wave's vectors are already on the card, as its queries: ``complete_wave``
keeps them (``index._pending_wave_vecs``) and the next snapshot delta
copies them into the table on the card instead of uploading the rows
again (ops/snapshot.py ``_delta_snapshot``), as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..errors import NodeExists
from ..utils import profiling
from . import distance as D
from .search import (
    _point_sims,
    _query_sqnorms,
    beam_search,
    hill_climb_layer,
    max_lanes_for,
)
from .snapshot import to_device

BUILD_EXPAND = 16     # candidates expanded per beam step during bulk build
BUILD_ITER_SLACK = 8  # extra beam steps beyond ceil(ef/expand)

# A bulk build's waves are timed as the host spans snapshot_refresh /
# device_pass / host_cross / fetch_results / host_surgery
# (utils/profiling.py: self time, no device sync; read by ``totals()``).


def _inert_rows(ids, sims, c):
    """The [B, c] beam output of lanes that did not beam: the entry point,
    then -1 / -inf (what ``beam_search`` returns for an inactive lane)."""
    B = ids.shape[0]
    out_i = torch.full((B, c), -1, dtype=torch.int32, device=ids.device)
    out_s = torch.full((B, c), float("-inf"), device=ids.device)
    out_i[:, 0] = ids
    out_s[:, 0] = sims
    return out_i, out_s


def _upper_layers(
    metric, q, qn, vecs, sqn, adj_up, upper_of, max_layer, levels, ids, sims,
    *, ef, expand, iters, c, l_keep, descend,
):
    """Layers L_pad .. 1 for lanes at ``levels``: at layer lc, lanes with
    level < lc hill-climb (when ``descend``), lanes with level >= lc beam
    ef-wide and move to their beam's best. Returns the final (ids, sims)
    and the beams' top ``c`` of layers 1 .. ``l_keep``, stacked [l_keep,
    B, c] (layer lc at index lc - 1). Layers above ``max_layer`` run
    nothing: their rows are the entry point, as the JAX scan's masked
    steps give them."""
    L_pad = adj_up.shape[0]
    up_ids, up_sims = [None] * l_keep, [None] * l_keep
    for lc in range(L_pad, 0, -1):
        if lc > max_layer:
            if lc <= l_keep:
                up_ids[lc - 1], up_sims[lc - 1] = _inert_rows(ids, sims, c)
            continue
        adj_l = adj_up[lc - 1]
        beaming = levels >= lc
        b_ids, b_sims = beam_search(
            metric, q, qn, vecs, sqn, adj_l, ids, sims, ef,
            row_map=upper_of, active=beaming, expand=expand, iters=iters,
        )
        if lc <= l_keep:
            up_ids[lc - 1], up_sims[lc - 1] = b_ids[:, :c], b_sims[:, :c]
        if descend:
            ids, sims = hill_climb_layer(
                metric, q, qn, vecs, sqn, adj_l, upper_of, ids, sims,
                active=~beaming,
            )
        # ep for the next layer: best of beam where beaming, else the
        # descent result (w.peek(), core.rs:576)
        ids = torch.where(beaming, b_ids[:, 0], ids)
        sims = torch.where(beaming, b_sims[:, 0], sims)
    B = ids.shape[0]
    if l_keep == 0:
        empty_i = torch.zeros((0, B, c), dtype=torch.int32, device=ids.device)
        return ids, sims, empty_i, empty_i.float()
    return ids, sims, torch.stack(up_ids), torch.stack(up_sims)


def _pack(*parts):
    """One int32 vector of ids and bitcast sims, raveled in order: the
    layout :func:`unpack_scores` inverts."""
    return torch.cat([
        (p if p.dtype == torch.int32 else p.view(torch.int32)).reshape(-1)
        for p in parts
    ])


def construct_scores(
    vecs, sqn, adj0, adj_up, upper_of, ep, max_layer,
    queries, levels, nbrvec=None, nbrsqn=None, qrows=None, up_sel=None,
    *, ef: int, metric: str, expand: int = 1, fetch_c: int | None = None,
    fetch_l: int | None = None,
):
    """One device pass scoring a whole insert wave against the snapshot.

    For each wave lane i with sampled level l_i (core.rs:511-577): greedy
    ef=1 descent at layers l_max..l_i+1, then an ef-wide beam at layers
    min(l_max, l_i)..0. ``levels`` [W] int32 on the device.

    Split upper beams: with ``up_sel`` (a compact lane list, pow2-padded
    by repeating up_sel[0]) every lane runs the hill-climb descent, only
    the gathered [W_up] lanes run the upper beams, and their layer-1 beam
    result is scattered back as the layer-0 entry point. Per-lane
    semantics are the same as the full-width loop (``up_sel=None``).

    Returns (flat, cross):
      flat packs, in order: up_ids [l_keep, W_up|W, C], up_sims
        (bitcast), l0_ids [W, C], l0_sims (bitcast) -- candidates at
        layer lc live at index lc-1, valid only for lanes with levels
        >= lc and lc <= max_layer;
      cross: [W, W] intra-wave sims (hamming) or None (euclidean: the
        host computes them, see dispatch_wave).

    ``C = min(ef, fetch_c)``: the surgery links only the top-m of each
    sorted list, so only C of the ef-wide beam are returned.
    """
    qn = _query_sqnorms(metric, queries)
    W = queries.shape[0]
    L_pad = adj_up.shape[0]
    max_layer = int(max_layer)
    ids = torch.full((W,), int(ep), dtype=torch.int32, device=queries.device)
    sims = _point_sims(metric, queries, qn, vecs, sqn, ids)
    iters = (ef + expand - 1) // expand + BUILD_ITER_SLACK
    c = min(ef, fetch_c) if fetch_c is not None else ef
    # only the first fetch_l upper layers are populated for this wave
    l_keep = L_pad if fetch_l is None else min(fetch_l, L_pad)
    kw = dict(ef=ef, expand=expand, iters=iters, c=c, l_keep=l_keep)

    if up_sel is None:
        ids, sims, up_ids, up_sims = _upper_layers(
            metric, queries, qn, vecs, sqn, adj_up, upper_of, max_layer,
            levels, ids, sims, descend=True, **kw,
        )
    else:
        # all-lane descent: layers l_max..l_i+1 (ef=1 hill climb)
        for lc in range(min(L_pad, max_layer), 0, -1):
            ids, sims = hill_climb_layer(
                metric, queries, qn, vecs, sqn, adj_up[lc - 1], upper_of,
                ids, sims, active=levels < lc,
            )
        # compact upper beams: layers min(l_max, l_i)..1
        sel = up_sel.long()
        ids_u, sims_u, up_ids, up_sims = _upper_layers(
            metric, queries[sel], qn[sel], vecs, sqn, adj_up, upper_of,
            max_layer, levels[sel], ids[sel], sims[sel], descend=False, **kw,
        )
        # layer-0 entry point of upper lanes = their layer-1 beam best
        # (duplicate up_sel pad entries scatter identical data)
        ids = ids.index_put((sel,), ids_u)
        sims = sims.index_put((sel,), sims_u)

    l0_ids, l0_sims = beam_search(
        metric, queries, qn, vecs, sqn, adj0, ids, sims, ef,
        expand=expand, iters=iters, nbrvec=nbrvec, nbrsqn=nbrsqn,
        qrows=qrows,
    )
    cross = D.pairwise_hamming(queries, queries) if metric == "hamming" \
        else None
    return _pack(up_ids, up_sims, l0_ids[:, :c], l0_sims[:, :c]), cross


def construct_upper_scores(
    vecs, sqn, adj_up, upper_of, ep, max_layer, queries, levels, up_sel,
    *, ef: int, metric: str, expand: int = 1, fetch_c: int = 32,
    fetch_l: int = 1,
):
    """Upper-layer half of a wave under scan-l0: only the compact
    ``up_sel`` lanes (levels >= 1) run the greedy descent (layers
    l_max..l_i+1) and the ef-wide beams (layers l_i..1); layer 0 never
    runs here, because the exact scan gives every lane's layer-0
    candidates. Returns the packed upper block only: up_ids [l_keep,
    W_up, C] then bitcast up_sims, raveled into one int32 vector."""
    sel = up_sel.long()
    q_u = queries[sel]
    qn_u = _query_sqnorms(metric, queries)[sel]
    ids_u = torch.full((q_u.shape[0],), int(ep), dtype=torch.int32,
                       device=queries.device)
    sims_u = _point_sims(metric, q_u, qn_u, vecs, sqn, ids_u)
    _, _, up_ids, up_sims = _upper_layers(
        metric, q_u, qn_u, vecs, sqn, adj_up, upper_of, int(max_layer),
        levels[sel], ids_u, sims_u, ef=ef, expand=expand,
        iters=(ef + expand - 1) // expand + BUILD_ITER_SLACK,
        c=min(ef, fetch_c), l_keep=min(fetch_l, adj_up.shape[0]),
        descend=True,
    )
    return _pack(up_ids, up_sims)


def unpack_scores(
    flat: np.ndarray, l_pad: int, w_pad: int, c: int,
    w_up: int | None = None,
):
    """Host-side inverse of construct_scores' packed return. ``w_up``
    is the compact upper-lane width when the wave ran the split upper
    beams (up_sel); defaults to the full wave width (unsplit)."""
    if w_up is None:
        w_up = w_pad
    n_up = l_pad * w_up * c
    n_l0 = w_pad * c
    up_ids = flat[:n_up].reshape(l_pad, w_up, c)
    up_sims = flat[n_up : 2 * n_up].view(np.float32).reshape(
        l_pad, w_up, c
    )
    l0_ids = flat[2 * n_up : 2 * n_up + n_l0].reshape(w_pad, c)
    l0_sims = flat[2 * n_up + n_l0 :].view(np.float32).reshape(w_pad, c)
    return up_ids, up_sims, l0_ids, l0_sims


def _select_top_m(index, cand_ids, cand_sims, m, exclude):
    """Top-m candidates by sim (bulk-path select; see module docstring).

    ``cand_*`` are parallel arrays sorted descending. Dedupes and drops
    ``exclude`` rows, free rows and the -1 / -inf padding of short lists.
    """
    out = []
    seen = set(exclude)
    for cid, s in zip(cand_ids, cand_sims):
        cid = int(cid)
        if cid < 0 or s == -np.inf or cid in seen:
            continue
        if not index._is_alloc(cid):
            continue  # freed row in the snapshot epoch gap
        seen.add(cid)
        out.append((float(s), cid))
        if len(out) == m:
            break
    return out


def _shrink_over_cap(index, e_row, lc, m_cap):
    """Degree-cap repair (core.rs:540-574) with top-m_cap selection."""
    e_nbrs = index._nbrs(e_row, lc)
    if len(e_nbrs) <= m_cap:
        return
    e_vec = index._vectors[e_row]
    e_sims = index._sims_to(e_vec, e_nbrs)
    order = sorted(
        zip(e_sims.tolist(), e_nbrs), key=lambda p: (-p[0], p[1])
    )
    keep = [r for _, r in order[:m_cap]]
    index._update_connections(e_row, keep, list(e_nbrs), lc)


def add_batch(index, names, data, batch_size: int = 1024) -> None:
    """Bulk insert via device-scored waves. Entry for HNSWIndex.add_batch."""
    data = np.atleast_2d(np.asarray(data, dtype=index._vectors.dtype))
    names = list(names)
    if len(names) != data.shape[0]:
        raise ValueError(
            f"{len(names)} names for {data.shape[0]} data rows"
        )
    if data.shape[0] == 0:
        return
    # Presize the device snapshot for the final size, so every wave's
    # refresh is a delta into the same tables.
    index._capacity_hint = max(
        int(getattr(index, "_capacity_hint", 0)),
        index._names.high_water + len(names),
    )
    start = 0
    if index.node_count == 0:
        index.add_node(names[0], data[0])
        start = 1

    ef = index.config.ef_construction
    lo = start
    while lo < len(names):
        with profiling.span("snapshot_refresh"):
            cap = max_lanes_for(index.device_snapshot().n_pad)
        hi = min(lo + min(batch_size, cap), len(names))
        _insert_wave(index, names[lo:hi], data[lo:hi], ef)
        lo = hi


def _pad_lanes(x: np.ndarray) -> np.ndarray:
    """Pad wave lanes (the first axis) to the next power of two >= 8 with
    zeros: zero vectors, level 0."""
    w = x.shape[0]
    w_pad = 8
    while w_pad < w:
        w_pad *= 2
    if w_pad == w:
        return x
    return np.concatenate(
        [x, np.zeros((w_pad - w,) + x.shape[1:], x.dtype)]
    )


def _host_cross(qs: np.ndarray) -> np.ndarray:
    """[W, W] matmul-form negative squared L2 on the host: torch's CPU
    sgemm for the dots, numpy for the norms, as the JAX package computes
    them, so every backend and both packages link from the same bits."""
    t = torch.from_numpy(qs)
    dots = (t @ t.T).numpy()
    qq = np.einsum("wd,wd->w", qs, qs)
    return (2.0 * dots - qq[:, None] - qq[None, :]).astype(np.float32)


def _wave_split() -> bool:
    """Split upper beams onto a compacted lane block (default on; see
    construct_scores). REDIS_HNSW_TPU_WAVE_SPLIT=0 restores the
    full-width layer loop."""
    return os.environ.get("REDIS_HNSW_TPU_WAVE_SPLIT", "1") != "0"


def _build_l0_scan(index, snap, fetch_c: int) -> bool:
    """Scan-l0 build mode: every lane's layer-0 candidates come from the
    exact scan (``scan_topk_exact_l2`` at k = fetch_c: kernel A's
    selection, exact direct-form rescore) instead of the ef-wide beam,
    and only the compact upper lanes run the graph program
    (:func:`construct_upper_scores`). The surgery is unchanged, and both
    backends consume the same candidate arrays.

    REDIS_HNSW_TPU_BUILD_L0 = beam | scan | auto ("auto", the default:
    scan for euclidean up to SCAN_MAX_ROWS padded rows, beam above it and
    for hamming builds). The JAX package selects with ``approx_max_k``
    here, which is exact off the TPU; kernel A's select is exact."""
    mode = os.environ.get("REDIS_HNSW_TPU_BUILD_L0", "auto").lower()
    if mode == "beam":
        return False
    if snap.metric != "euclidean":
        return False  # hamming builds keep the beam path
    if snap.n_pad < fetch_c:
        return False  # tiny snapshot: the scan would narrow the slice
    if mode == "scan":
        return True
    from .search import SCAN_MAX_ROWS

    return snap.n_pad <= SCAN_MAX_ROWS["euclidean"]


def _build_live_mask(index, snap):
    """Per-epoch device live mask for scan-l0 candidate masking, kept on
    its own cache slot (``_build_live_cache``)."""
    cached = getattr(index, "_build_live_cache", None)
    ep = index._snapshot_epoch
    if cached is not None and cached[0] == ep:
        return cached[1]
    live_np = np.zeros(snap.n_pad, bool)
    h = min(len(index._levels), snap.n_pad, snap.live_hw)
    live_np[:h] = index._levels[:h] >= 0
    live = to_device(live_np, snap.vecs.device)
    index._build_live_cache = (ep, live)
    return live


class InFlightWave:
    """A dispatched (but not yet applied) construction wave: its device
    work is queued; ``complete_wave`` fetches and applies it."""

    __slots__ = (
        "names", "qs", "qs_dev", "levels", "flat", "cross",
        "w_pad", "fetch_c", "fetch_l", "n_up_used", "l_max",
        "up_sel", "w_up",
    )


def dispatch_wave(index, names, data, ef: int) -> InFlightWave:
    """Sample levels and queue the wave's device pass. The caller must
    ``complete_wave`` before the index's next mutation."""
    cfg = index.config
    W = len(names)
    # 1. sample levels (core.rs:601-605), all W before any surgery
    qs = np.stack([index._coerce(d) for d in data])
    for n in names:
        if n in index._names:
            raise NodeExists(n)
    levels = np.array(
        [index._gen_random_level() for _ in range(W)], np.int32
    )

    # 2. one device pass against the wave-start snapshot. The wave is
    # padded to a power of two (padding lanes: zero vectors, level 0,
    # results ignored).
    snap = index.device_snapshot()
    dev = snap.vecs.device
    l_max = int(index.max_layer)
    qs_pad, levels_d = _pad_lanes(qs), _pad_lanes(levels)
    w_pad = len(qs_pad)
    # only the top-m of each sorted candidate list is ever linked (plus
    # slack for rows freed since the snapshot / duplicates)
    fetch_c = min(ef, max(4 * cfg.m, cfg.m_max_0 + 16, 32))
    n_up_used = int(min(l_max, int(levels.max(initial=0))))
    # upper-layer slice of the packed fetch, bucketed to powers of two
    fetch_l = 1
    while fetch_l < n_up_used:
        fetch_l *= 2
    fetch_l = min(fetch_l, int(snap.adj_up.shape[0]))
    # split upper beams: compact lane list, pow2-padded by repeating its
    # first entry. Lanes with level 0 in the pad are inert in every upper
    # beam (their beaming mask is False).
    scan_l0 = _build_l0_scan(index, snap, fetch_c)
    up_sel = None
    if _wave_split() or scan_l0:
        up_lanes = np.nonzero(levels >= 1)[0].astype(np.int32)
        if up_lanes.size == 0:
            up_lanes = np.zeros(1, np.int32)
        # width sized to the mean + 5 sigma of the upper count (W/m), as
        # the JAX package sizes it, so the packed layout is the same
        mu = w_pad / max(cfg.m, 2)
        w_up = 8
        while w_up < min(max(up_lanes.size, mu + 5 * mu**0.5), w_pad):
            w_up *= 2
        up_sel = np.full(w_up, up_lanes[0], np.int32)
        up_sel[: up_lanes.size] = up_lanes
    with profiling.span("device_pass"):
        qs_dev = to_device(qs_pad, dev)
        lv_dev = to_device(levels_d, dev)
        sel_dev = None if up_sel is None else to_device(up_sel, dev)
        if scan_l0:
            # layer-0 candidates for every lane from the exact scan
            # (kernel A), sorted by (-sim, id); only the compact upper
            # lanes run the graph program
            from .scan import scan_topk_exact_l2

            live = _build_live_mask(index, snap)
            ids, sims = scan_topk_exact_l2(
                snap.vecs, snap.sqnorms, live, qs_dev, k=fetch_c,
            )
            flat = _pack(ids, sims)
            if n_up_used > 0:
                flat = torch.cat([construct_upper_scores(
                    snap.vecs, snap.sqnorms, snap.adj_up, snap.upper_of,
                    snap.ep, snap.max_layer, qs_dev, lv_dev, sel_dev,
                    ef=ef, metric=snap.metric, expand=BUILD_EXPAND,
                    fetch_c=fetch_c, fetch_l=fetch_l,
                ), flat])
            else:
                fetch_l = 0
            cross = None
        else:
            flat, cross = construct_scores(
                snap.vecs, snap.sqnorms, snap.adj0, snap.adj_up,
                snap.upper_of, snap.ep, snap.max_layer, qs_dev, lv_dev,
                snap.nbrvec, snap.nbrsqn, snap.qrows, sel_dev,
                ef=ef, metric=snap.metric, expand=BUILD_EXPAND,
                fetch_c=fetch_c, fetch_l=fetch_l,
            )
    if cross is None:
        # euclidean intra-wave sims: a small host gemm that both backends
        # consume, so py/native builds stay identical
        with profiling.span("host_cross"):
            cross = _host_cross(qs)
    w = InFlightWave()
    w.names, w.qs, w.qs_dev, w.levels = names, qs, qs_dev, levels
    w.flat, w.cross, w.w_pad = flat, cross, w_pad
    w.fetch_c, w.fetch_l, w.n_up_used, w.l_max = (
        fetch_c, fetch_l, n_up_used, l_max
    )
    w.up_sel = up_sel
    w.w_up = None if up_sel is None else len(up_sel)
    return w


def _insert_wave(index, names, data, ef: int) -> None:
    """Insert one wave: dispatch its device pass, then apply it."""
    complete_wave(index, dispatch_wave(index, names, data, ef))


def complete_wave(index, wave: InFlightWave) -> None:
    """Fetch a dispatched wave's device results and apply host surgery."""
    cfg = index.config
    names, qs, levels = wave.names, wave.qs, wave.levels
    cross, l_max = wave.cross, wave.l_max
    W = len(names)
    with profiling.span("fetch_results"):
        # one device->host copy of the packed buffer, then host slicing
        up_ids, up_sims, l0_ids, l0_sims = unpack_scores(
            wave.flat.cpu().numpy(),
            l_pad=wave.fetch_l,
            w_pad=wave.w_pad,
            c=wave.fetch_c,
            w_up=wave.w_up,
        )
        if wave.up_sel is not None:
            # expand the compact upper-lane block back to wave order;
            # level-0 lanes never read their rows -- fill inert
            n_up = wave.n_up_used
            full_i = np.full((n_up, W, wave.fetch_c), -1, np.int32)
            full_s = np.full(
                (n_up, W, wave.fetch_c), -np.inf, np.float32
            )
            sel = wave.up_sel
            full_i[:, sel] = up_ids[:n_up]
            full_s[:, sel] = up_sims[:n_up]
            up_ids, up_sims = full_i, full_s
        else:
            up_ids = np.ascontiguousarray(up_ids[: wave.n_up_used, :W])
            up_sims = np.ascontiguousarray(up_sims[: wave.n_up_used, :W])
        l0_ids = np.ascontiguousarray(l0_ids[:W])
        l0_sims = np.ascontiguousarray(l0_sims[:W])
        if isinstance(cross, torch.Tensor):
            cross = cross[:W, :W].cpu().numpy()

    # 3. host surgery, in wave order (core.rs:523-599 per insert)
    if index._native is not None:
        with profiling.span("host_surgery"):
            rows = np.empty(W, np.int32)
            for i in range(W):
                rows[i] = index._alloc_row(
                    names[i], qs[i], level=int(levels[i])
                )
            # the wave's vectors are already on the card (its queries):
            # the next snapshot delta copies them from there
            index._pending_wave_vecs = (rows.copy(), wave.qs_dev[:W])
            index._native.apply_wave(
                rows, levels, up_ids, up_sims, l0_ids, l0_sims, cross, l_max,
            )
            for i in range(W):
                index._finish_insert(int(rows[i]), int(levels[i]))
            index._bump(W)
        return

    with profiling.span("host_surgery"):
        rows = np.empty(W, np.int64)
        m = cfg.m
        for i in range(W):
            lv = int(levels[i])
            row = index._alloc_row(names[i], qs[i], level=lv)
            rows[i] = row

            # earlier wave members are candidates via exact cross sims
            for lc in range(min(l_max, lv), -1, -1):
                if lc == 0:
                    cids, csims = l0_ids[i], l0_sims[i]
                else:
                    cids, csims = up_ids[lc - 1, i], up_sims[lc - 1, i]
                cand_ids = list(cids)
                cand_sims = list(csims)
                if i:
                    mates = np.nonzero(levels[:i] >= lc)[0]
                    if mates.size:
                        cand_ids.extend(rows[mates])
                        cand_sims.extend(cross[i, mates])
                # (-sim, id) order: deterministic ties, matches the
                # native core's apply_wave sort
                cand_ids = np.asarray(cand_ids)
                cand_sims = np.asarray(cand_sims)
                order = np.lexsort((cand_ids, -cand_sims))
                sel = _select_top_m(
                    index, cand_ids[order], cand_sims[order], m,
                    exclude=(row,),
                )
                index._connect_neighbors(row, sel, lc)
                m_cap = cfg.m_max_0 if lc == 0 else cfg.m_max
                for _, e_row in sel:
                    _shrink_over_cap(index, e_row, lc, m_cap)

            index._finish_insert(row, lv)
        index._pending_wave_vecs = (rows.copy(), wave.qs_dev[:W])
        index._bump(W)
