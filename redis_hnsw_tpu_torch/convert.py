"""Carry an index's state across packages: the checkpoint layout.

An index's state is a dict of numpy arrays under the keys of the JAX
package's checkpoint format v1 (``redis_hnsw_tpu/utils/checkpoint.py``
save_index / save_flat_index): ``meta`` (the parsed JSON dict),
``names`` (dtype ``"U"``, ``""`` on free rows), ``vectors`` and, for
``kind="hnsw"``, ``levels``, ``adj_counts`` and ``adj_flat``; for
``kind="flat"``, ``valid``.

``state_from_index`` reads that state off an index of this package;
``index_from_state`` builds an index from it the way the JAX package's
``load_index`` does, so the host tables (vectors, levels, adjacency,
name table) are byte-equal to the source index's and every later
snapshot and reply matches. ``utils/checkpoint.py`` writes and reads the
state as the JAX package's npz files, so a checkpoint of either package
restores in the other.

A sharded index's state is ``(manifest, [state per shard])`` in the JAX
package's sharded checkpoint layout v1 (``ShardedHNSW.save``: the
manifest holds ``format_version``, ``name``, ``n_shards`` and six config
keys); :func:`sharded_state` reads it and :func:`sharded_from_state`
builds a ``parallel.ShardedHNSW`` from it. The host layers of the two
packages are the same, so ``sharded_state`` of a JAX ``ShardedHNSW``
carries it into this package without a file.
"""

from __future__ import annotations

import numpy as np

from .config import IndexConfig
from .errors import HNSWError

FORMAT_VERSION = 1


def _config_meta(index) -> dict:
    """The seven IndexConfig keys a checkpoint records (``backend`` is a
    property of the process, not of the index, and is not written)."""
    cfg = index.config
    return {
        "dim": cfg.dim,
        "m": cfg.m,
        "ef_construction": cfg.ef_construction,
        "metric": cfg.metric,
        "capacity": cfg.capacity,
        "fixed_capacity": cfg.fixed_capacity,
        "seed": cfg.seed,
    }


def _names_array(index, h: int) -> np.ndarray:
    """Row -> name over the first ``h`` rows, ``""`` on free rows."""
    return np.array(
        [
            index._names._name_of[r]
            if index._names._name_of[r] is not None else ""
            for r in range(h)
        ],
        dtype="U",
    )


def state_from_index(index) -> dict:
    """The state of an HNSWIndex or FlatIndex (the inverse of
    :func:`index_from_state`): host tables only, no device tensor is
    read. The arrays are views of the index's tables where they can
    be, so write them out before the index mutates again."""
    from .models.flat import FlatIndex

    h = index._names.high_water
    if isinstance(index, FlatIndex):
        return {
            "meta": {
                "format_version": FORMAT_VERSION,
                "kind": "flat",
                "name": index.name,
                "config": _config_meta(index),
                "node_count": index.node_count,
            },
            "names": _names_array(index, h),
            "vectors": index._vectors[:h],
            "valid": index._valid[:h],
        }
    n_layers = index.max_layer + 1
    if index._native is not None:
        counts, flat = index._native.export_all(h, n_layers)
    else:
        counts = np.zeros((h, n_layers), np.int32)
        flat_l: list[int] = []
        for row in range(h):
            lists = index._neighbors[row]
            if lists is None:
                continue
            for lc, layer in enumerate(lists):
                counts[row, lc] = len(layer)
                flat_l.extend(layer)
        flat = np.asarray(flat_l, np.int32)
    return {
        "meta": {
            "format_version": FORMAT_VERSION,
            "kind": "hnsw",
            "name": index.name,
            "config": _config_meta(index),
            "node_count": index.node_count,
            "max_layer": index.max_layer,
            "enterpoint": int(index.enterpoint),
            # a restored index keeps hint-exact snapshot shapes
            "capacity_hint": int(index._capacity_hint),
        },
        "names": _names_array(index, h),
        "vectors": index._vectors[:h],
        "levels": index._levels[:h],
        "adj_counts": counts,
        "adj_flat": np.asarray(flat, np.int32),
    }


def index_from_state(state: dict, device=None):
    """Build an HNSWIndex or FlatIndex on ``device`` (None = the card)
    from a JAX-package index state (see the module docstring)."""
    from .models.flat import FlatIndex
    from .models.hnsw import HNSWIndex

    meta = state["meta"]
    if meta.get("format_version", FORMAT_VERSION) != FORMAT_VERSION:
        raise HNSWError(
            f"cannot load checkpoint format version "
            f"{meta['format_version']} (supported: {FORMAT_VERSION})"
        )
    cfg = IndexConfig(**meta["config"])
    names = state["names"]
    vectors = state["vectors"]
    h = len(names)
    if meta.get("kind", "hnsw") == "flat":
        valid = np.asarray(state["valid"], bool)
        index = FlatIndex(meta["name"], cfg, device=device)
        if h > index._vectors.shape[0]:
            index._vectors = np.array(vectors, index._vectors.dtype)
            index._valid = valid.copy()
        else:
            index._vectors[:h] = vectors
            index._valid[:h] = valid
        _fill_names(index._names, names, valid)
        index._epoch += 1
        return index

    levels = np.asarray(state["levels"], np.int32)
    counts = state["adj_counts"]
    flat = state["adj_flat"]
    index = HNSWIndex(meta["name"], cfg, device=device)
    index._grow(max(h, 1))
    index._vectors[:h] = vectors
    index._levels[:h] = levels
    # liveness comes from levels[row] >= 0 (delete stamps -1)
    _fill_names(index._names, names, levels >= 0)

    pos = 0
    max_layer = int(meta["max_layer"])
    while len(index._layer_sets) < max_layer + 1:
        index._layer_sets.append(set())
    for row in range(h):
        if levels[row] < 0:
            continue  # free row: its count block is empty
        lists = []
        for lc in range(counts.shape[1]):
            c = int(counts[row, lc])
            lists.append([int(x) for x in flat[pos : pos + c]])
            pos += c
        # trim trailing empty layers beyond the row's level
        lvl = int(levels[row])
        while len(lists) > lvl + 1 and not lists[-1]:
            lists.pop()
        if index._native is not None:
            index._native.alloc_node(row, lvl)
            for lc, layer in enumerate(lists):
                if layer:
                    index._native.set_neighbors(row, lc, layer)
        else:
            index._neighbors[row] = lists
        if lvl >= 1:
            index._upper_slot[row] = index._upper_next
            index._upper_next += 1
        index._layer_sets[lvl].add(row)
    while len(index._layer_sets) > max_layer + 1:
        index._layer_sets.pop()

    index.node_count = int(meta["node_count"])
    index.max_layer = max_layer
    index.enterpoint = int(meta["enterpoint"])
    index._capacity_hint = max(
        index._capacity_hint, int(meta.get("capacity_hint", 0))
    )
    index._bump()
    return index


def _fill_names(table, names, live) -> None:
    """Rebuild a NameTable preserving row ids (free rows -> free list)."""
    for row in range(len(names)):
        name = str(names[row])
        if live[row]:
            table._name_of.append(name)
            table._id_of[name] = row
        else:
            table._name_of.append(None)
            table._free.append(row)


def sharded_state(index) -> tuple[dict, list[dict]]:
    """``(manifest, [state per shard])`` of a sharded index (the inverse
    of :func:`sharded_from_state`)."""
    cfg = index.config
    manifest = {
        "format_version": FORMAT_VERSION,
        "name": index.name,
        "n_shards": index.n_shards,
        "config": {
            "dim": cfg.dim,
            "m": cfg.m,
            "ef_construction": cfg.ef_construction,
            "metric": cfg.metric,
            "capacity": cfg.capacity,
            "seed": cfg.seed,
        },
    }
    return manifest, [state_from_index(s) for s in index.shards]


def sharded_from_state(manifest: dict, states, mesh=None, device=None):
    """Build a ``parallel.ShardedHNSW`` from a sharded state: on ``mesh``
    (default ``make_mesh(n_shards, device)``), which must have the
    state's shard count; shard s goes to the mesh's s-th device. A
    manifest of another format version is refused (HNSWError)."""
    from .parallel.sharded import ShardedHNSW, resolve_mesh

    if manifest.get("format_version") != FORMAT_VERSION:
        raise HNSWError(
            "cannot load sharded checkpoint format version "
            f"{manifest.get('format_version')} (supported: {FORMAT_VERSION})"
        )
    n = int(manifest["n_shards"])
    mesh = resolve_mesh(mesh, n, device)
    if mesh.devices.size != n or len(states) != n:
        raise HNSWError(
            f"checkpoint has {n} shards but the mesh provides "
            f"{mesh.devices.size} devices"
        )
    shards = [index_from_state(state, device=dev)
              for state, dev in zip(states, mesh.devices.flat)]
    return ShardedHNSW(manifest["name"], IndexConfig(**manifest["config"]),
                       mesh=mesh, shards=shards)
