"""Carry an index of the JAX package across into this package.

``index_from_state`` takes an index's state as numpy arrays under the keys
of the JAX package's checkpoint format v1 (``redis_hnsw_tpu/utils/
checkpoint.py`` save_index / save_flat_index): ``meta`` (the parsed JSON
dict), ``names``, ``vectors`` and, for ``kind="hnsw"``, ``levels``,
``adj_counts`` and ``adj_flat``; for ``kind="flat"``, ``valid``. It builds
the index the way the JAX package's ``load_index`` does, so the host
tables (vectors, levels, adjacency, name table) are byte-equal to the
source index's and every later snapshot and reply matches. This is how
this engine takes over the data of a deployed JAX index (the arrays of
its checkpoint file, with ``meta`` decoded from JSON); reading and
writing checkpoint files is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import numpy as np

from .config import IndexConfig
from .errors import HNSWError

FORMAT_VERSION = 1


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
