"""Index configuration.

A typed, validated dataclass in place of the reference's declarative
command-argument schemas (zhao-lang/redis_hnsw src/lib.rs:37-129), as in
``redis_hnsw_tpu/config.py``. Defaults mirror the reference: ``m=5``
(src/lib.rs:48), ``ef_construction=200`` (src/lib.rs:53), search ``k=5``
(src/lib.rs:120). Derived hyperparameters mirror ``Index::new``
(src/hnsw/core.rs:335-338): ``m_max = m``, ``m_max_0 = 2m``,
``level_mult = 1/ln(m)``.
"""

from __future__ import annotations

import dataclasses
import math

from .errors import HNSWError

METRICS = ("euclidean", "hamming")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Hyperparameters of one HNSW index.

    dim: dimensionality of the data (reference: required DIM kwarg).
    m: out-degree target per node (reference default 5).
    ef_construction: beam width for construction *and* (in parity mode)
        search -- the reference hardwires search ef to ef_construction
        (src/hnsw/core.rs:485).
    metric: "euclidean" (negative squared L2, src/hnsw/metrics.rs:75-83) or
        "hamming" (XOR+popcount over packed uint32 words).
    capacity: initial row capacity of the tables; grows geometrically on
        demand.
    fixed_capacity: refuse to grow past ``capacity`` (CapacityError)
        instead of reallocating -- pins the device memory footprint.
    seed: seed of the level sampler (numpy ``default_rng``).
    backend: host graph engine: "native" (C++ core, csrc/hnsw_core.cpp),
        "py" (pure Python, identical semantics), or "auto" (native when
        the library is available or buildable, else py).
    """

    dim: int
    m: int = 5
    ef_construction: int = 200
    metric: str = "euclidean"
    capacity: int = 1024
    fixed_capacity: bool = False
    seed: int | None = None
    backend: str = "auto"

    def __post_init__(self) -> None:
        if self.backend not in ("auto", "py", "native"):
            raise HNSWError(
                f"backend must be auto|py|native, got {self.backend!r}"
            )
        if self.dim <= 0:
            raise HNSWError(f"data dimension must be positive, got {self.dim}")
        if self.m < 2:
            # level_mult = 1/ln(m) requires m >= 2 (reference allows m=1 but
            # then level sampling divides by ln(1)=0; we reject it up front).
            raise HNSWError(f"M must be >= 2, got {self.m}")
        if self.ef_construction < 1:
            raise HNSWError(
                f"EFCON must be >= 1, got {self.ef_construction}"
            )
        if self.metric not in METRICS:
            raise HNSWError(
                f"metric must be one of {METRICS}, got {self.metric!r}"
            )
        if self.metric == "hamming" and self.dim % 32 != 0:
            raise HNSWError("hamming metric requires dim % 32 == 0 (packed bits)")

    # Derived parameters (src/hnsw/core.rs:335-338).
    @property
    def m_max(self) -> int:
        return self.m

    @property
    def m_max_0(self) -> int:
        return self.m * 2

    @property
    def level_mult(self) -> float:
        return 1.0 / math.log(float(self.m))


def resolve_device(device=None):
    """The torch device an index lives on. ``None`` means ``"cuda"``:
    the engine serves from the card unless the caller asks for the CPU
    (``device="cpu"``, as the CPU tests do). A CUDA device that is not
    there raises instead of falling back to the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HNSWError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise HNSWError(f"unsupported device {dev}")
    return dev
