"""redis_hnsw_tpu_torch: the HNSW index-and-query engine on PyTorch + CUDA.

The port of ``redis_hnsw_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
command surface of zhao-lang/redis_hnsw (index create/inspect/drop, node
add/get/delete with online graph repair, k-NN search) plus bulk
construction and batched search, checkpoints in the JAX package's file
format, a RESP server (``python -m redis_hnsw_tpu_torch.server``), the
streaming insert+query mix (``run_mixed``) and search-knob tuning
(``tune``), served by hand-written CUDA kernels (``csrc/``). Indexes live
on the card unless the client is created with ``device="cpu"``;
``default_client`` is made on first access, on the card. ROADMAP.md lists
what is not ported yet; those entry points raise ``NotImplementedError``.

The JAX package's ``enable_compilation_cache`` has no counterpart: there
is no XLA cache here, and ``utils/build.py`` builds the kernels once into
``build/``.
"""

from .api import HNSW
from .config import IndexConfig
from .convert import index_from_state, state_from_index
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
from .utils.autotune import tune
from .utils.streaming import run_mixed

__version__ = "0.1.0"


def __getattr__(name: str):
    """``default_client`` (api.py): made on first access, on the card.
    It is left out of ``__all__`` so a star import touches no device."""
    if name == "default_client":
        from . import api

        return api.default_client
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "HNSW",
    "IndexConfig",
    "HNSWIndex",
    "FlatIndex",
    "SearchResult",
    "index_from_state",
    "state_from_index",
    "HNSWError",
    "DimensionMismatch",
    "IndexExists",
    "IndexNotFound",
    "NodeExists",
    "NodeNotFound",
    "NodeBusy",
    "CapacityError",
    "tune",
    "run_mixed",
    "__version__",
]
