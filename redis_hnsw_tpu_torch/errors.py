"""Error types of the PyTorch/CUDA HNSW engine.

Same classes and messages as ``redis_hnsw_tpu/errors.py``, which mirror
the error semantics of the reference implementation (zhao-lang/redis_hnsw,
src/hnsw/core.rs:24-46 ``HNSWError`` plus the string errors raised at the
command layer, src/lib.rs:146-149, :242, :385-391), so a user migrating
from the Redis module, or from the JAX package, sees the same diagnostics.
"""

from __future__ import annotations


class HNSWError(Exception):
    """Base error. Reference: ``HNSWError`` (src/hnsw/core.rs:24-28)."""


class DimensionMismatch(HNSWError):
    """Data dimensionality does not match the index.

    Reference: src/hnsw/core.rs:389-391 (add) and :478-480 (search).
    """

    def __init__(self, got: int) -> None:
        super().__init__(f"data dimension: {got} does not match Index")
        self.got = got


class IndexExists(HNSWError):
    """Reference: src/lib.rs:146-149."""

    def __init__(self, name: str) -> None:
        super().__init__(f"Index: {name} already exists")
        self.name = name


class IndexNotFound(HNSWError):
    """Reference: src/lib.rs:242, :205."""

    def __init__(self, name: str) -> None:
        super().__init__(f"Index: {name} does not exist")
        self.name = name


class NodeExists(HNSWError):
    """Reference: src/hnsw/core.rs:407-409."""

    def __init__(self, name: str) -> None:
        super().__init__(f"Node: {name!r} already exists")
        self.name = name


class NodeNotFound(HNSWError):
    """Reference: src/hnsw/core.rs:419-421, src/lib.rs:441."""

    def __init__(self, name: str) -> None:
        super().__init__(f"Node: {name!r} does not exist")
        self.name = name


class NodeBusy(HNSWError):
    """Reference: the busy-guard at src/lib.rs:385-391.

    The reference refuses to delete a node whose ``Arc`` strong count
    exceeds 1. This engine keeps the class for API compatibility but never
    raises it: mutations are serialized per index (api.py index locks) and
    readers work on snapshots, so the condition cannot arise.
    """

    def __init__(self, name: str) -> None:
        super().__init__(
            f"{name} is being accessed, unable to delete. Try again later"
        )
        self.name = name


class CapacityError(HNSWError):
    """Index cannot grow: ``IndexConfig.fixed_capacity`` pins the row
    capacity (device memory footprint, table shapes) and an insert needs
    a row beyond it. No reference equivalent (the pointer graph grows
    unboundedly)."""
