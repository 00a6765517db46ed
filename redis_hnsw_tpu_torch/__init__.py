"""redis_hnsw_tpu_torch: the HNSW index-and-query engine on PyTorch + CUDA.

The port of ``redis_hnsw_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
command surface of zhao-lang/redis_hnsw (index create/inspect/drop, node
add/get/delete with online graph repair, k-NN search) plus bulk
construction and batched search, served by hand-written CUDA kernels
(``csrc/``). Indexes live on the card unless the client is created with
``device="cpu"``. ROADMAP.md lists what is not ported yet; those entry
points raise ``NotImplementedError``.
"""

from .api import HNSW
from .config import IndexConfig
from .convert import index_from_state
from .errors import (
    CapacityError,
    DimensionMismatch,
    HNSWError,
    IndexExists,
    IndexNotFound,
    NodeBusy,
    NodeExists,
    NodeNotFound,
)
from .models.flat import FlatIndex
from .models.hnsw import HNSWIndex, SearchResult

__version__ = "0.1.0"

__all__ = [
    "HNSW",
    "IndexConfig",
    "HNSWIndex",
    "FlatIndex",
    "SearchResult",
    "index_from_state",
    "HNSWError",
    "DimensionMismatch",
    "IndexExists",
    "IndexNotFound",
    "NodeExists",
    "NodeNotFound",
    "NodeBusy",
    "CapacityError",
    "__version__",
]
