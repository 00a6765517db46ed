from .mesh import DATA_AXIS, SLICE_AXIS, Mesh, make_mesh, make_mesh2d
from .sharded import ShardedHNSW

__all__ = [
    "DATA_AXIS",
    "SLICE_AXIS",
    "Mesh",
    "make_mesh",
    "make_mesh2d",
    "ShardedHNSW",
]
