"""Device meshes for the sharded index.

Port of ``redis_hnsw_tpu/parallel/mesh.py``. A JAX ``Mesh`` names the
devices one jitted program spans; here one process drives a list of
``torch.device`` objects itself (parallel/sharded.py), so a mesh is the
small object below, with the attributes the sharded index reads off a
JAX mesh: ``devices`` (a numpy object array of ``torch.device``),
``axis_names`` and ``shape[axis]``.

On CUDA the helpers take the first n visible cards and raise when there
are too few. The CPU is one device in torch, so on the CPU they repeat
it n times -- the counterpart of the JAX tests' forced host device count
(tests/conftest.py). A mesh may also be built from any explicit devices,
repeats included: several shards then share one card.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
SLICE_AXIS = "slice"


class Mesh:
    """A named grid of torch devices, row-major (shard s of a sharded
    index lives on ``devices.flat[s]``)."""

    def __init__(self, devices, axis_names=(DATA_AXIS,)) -> None:
        flat = [torch.device(d) for d in np.asarray(devices, object).flat]
        grid = np.empty(len(flat), object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(np.asarray(devices, object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D devices for axes {self.axis_names}"
            )
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _devices(n: int | None, device) -> list:
    """The first ``n`` visible devices of ``device``'s type (None = the
    card): n cards, or the CPU n times. ``n=None`` takes every visible
    card (the CPU once)."""
    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else int(n))
    have = torch.cuda.device_count()
    if n is not None and have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(have if n is None else n)]


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A 1-D ``data`` mesh of ``n_devices`` devices (see :func:`_devices`)."""
    return Mesh(_devices(n_devices, device), (DATA_AXIS,))


def make_mesh2d(n_slices: int, chips_per_slice: int, device=None) -> Mesh:
    """A two-level (``slice``, ``data``) mesh. The sharded engines merge
    top-k over it innermost axis first: within each slice, then across
    slices, as the JAX package's hierarchical merge does (there the
    ``data`` axis is a slice's ICI, the ``slice`` axis the slower DCN)."""
    devs = _devices(n_slices * chips_per_slice, device)
    grid = np.empty(len(devs), object)
    grid[:] = devs
    return Mesh(grid.reshape(n_slices, chips_per_slice),
                (SLICE_AXIS, DATA_AXIS))
