"""Versioned checkpoint save/restore.

Port of ``redis_hnsw_tpu/utils/checkpoint.py``, in its file format
exactly, so a checkpoint written by either package restores in the other:
one ``.npz`` whose ``meta`` entry is the JSON envelope (``format_version``
1, ``kind``, ``name``, the seven config keys, counts) encoded as uint8,
beside ``names`` (dtype ``"U"``, ``""`` on free rows), ``vectors`` and,
for ``kind="hnsw"``, ``levels``, ``adj_counts`` and ``adj_flat``; for
``kind="flat"``, ``valid``. The reference persists through Redis RDB
callbacks (zhao-lang/redis_hnsw src/types.rs:157-284), version-gated at
:181; here the index is a handful of dense arrays, so a checkpoint is
those arrays, and edges are row ids that need no rewiring on load.

The arrays are :func:`convert.state_from_index`; a load rebuilds the index
through :func:`convert.index_from_state`, the one loader of both kinds.
Writes are atomic: a tmp file, then ``os.replace``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..convert import FORMAT_VERSION, index_from_state, state_from_index

__all__ = ["FORMAT_VERSION", "save_index", "save_flat_index", "load_index"]


def _write(state: dict, path: str, compress: bool) -> None:
    arrays = dict(state)
    arrays["meta"] = np.frombuffer(
        json.dumps(state["meta"]).encode("utf-8"), dtype=np.uint8
    )
    tmp = path + ".tmp"
    writer = np.savez_compressed if compress else np.savez
    with open(tmp, "wb") as f:
        writer(f, **arrays)
    os.replace(tmp, path)


def save_index(index, path: str, compress: bool = True) -> None:
    """Serialize an HNSWIndex or FlatIndex to ``path`` (npz, atomic
    rename). ``compress=False`` trades file size for speed (large
    indexes, staged builds)."""
    _write(state_from_index(index), path, compress)


def save_flat_index(index, path: str, compress: bool = True) -> None:
    """Serialize a FlatIndex: the same envelope with ``kind="flat"`` and
    (vectors, valid) in place of the adjacency."""
    save_index(index, path, compress=compress)


def load_index(path: str, device=None):
    """Restore an index from a checkpoint of either package onto
    ``device`` (None = the card); inverse of :func:`save_index`. Unknown
    format versions are refused, not migrated (HNSWError), as the
    reference refuses unknown encvers (types.rs:181-182)."""
    with np.load(path, allow_pickle=False) as z:
        state = {key: z[key] for key in z.files}
    state["meta"] = json.loads(bytes(state["meta"].tobytes()).decode("utf-8"))
    return index_from_state(state, device=device)
