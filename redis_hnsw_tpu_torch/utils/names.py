"""Host-side name <-> row-id table with free-list reuse.

The reference keeps ``nodes: HashMap<String, Node>`` (src/hnsw/core.rs:316);
here names live only on the host while the graph itself is dense int32 row
ids, so the device never sees a string. Deleted rows go on a free list and
are reused by later inserts (the reference reuses nothing -- rows are
heap-allocated nodes -- so this is purely an allocator detail).
"""

from __future__ import annotations


class NameTable:
    __slots__ = ("_id_of", "_name_of", "_free", "_np_cache")

    def __init__(self) -> None:
        self._id_of: dict[str, int] = {}
        self._name_of: list[str | None] = []
        self._free: list[int] = []
        self._np_cache = None  # object ndarray mirror of _name_of

    def names_array(self):
        """Object-ndarray view of the row -> name map, cached until the
        next alloc/free. Lets batched reply assembly resolve [B, k] row
        ids with one fancy-index instead of B*k list lookups."""
        if self._np_cache is None:
            import numpy as np

            self._np_cache = np.array(self._name_of, dtype=object)
        return self._np_cache

    def __len__(self) -> int:
        return len(self._id_of)

    def __contains__(self, name: str) -> bool:
        return name in self._id_of

    def get(self, name: str) -> int | None:
        return self._id_of.get(name)

    def name(self, node_id: int) -> str:
        n = self._name_of[node_id]
        assert n is not None, f"row {node_id} is free"
        return n

    def names(self) -> list[str]:
        return list(self._id_of.keys())

    def items(self):
        return self._id_of.items()

    def alloc(self, name: str) -> int:
        assert name not in self._id_of
        self._np_cache = None
        if self._free:
            node_id = self._free.pop()
            self._name_of[node_id] = name
        else:
            node_id = len(self._name_of)
            self._name_of.append(name)
        self._id_of[name] = node_id
        return node_id

    def free(self, name: str) -> int:
        self._np_cache = None
        node_id = self._id_of.pop(name)
        self._name_of[node_id] = None
        self._free.append(node_id)
        return node_id

    @property
    def high_water(self) -> int:
        """Rows ever allocated (dense array rows in use, incl. free holes)."""
        return len(self._name_of)
