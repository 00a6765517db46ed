"""The pure-Python ``SearchResult``: the reply's type where the native
one (csrc/reply.cpp) cannot be built. It has a module of its own so that
pickle finds it under its own name, since models/hnsw.py's
``SearchResult`` names the native type wherever that builds."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(slots=True)
class SearchResult:
    """Mirror of the reference's SearchResult (core.rs:48-62).

    ``data`` is None in batch replies (the reference's search reply also
    carries only similarity + name, src/types.rs:445-457); single-query
    ``search_knn`` fills it like HNSW.NODE.GET would.
    """

    sim: float
    name: str
    data: np.ndarray | None = None
