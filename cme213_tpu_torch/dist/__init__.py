from .mesh import Mesh, make_mesh_1d, make_mesh_2d, mesh_for_method
from .heat import (distributed_heat_step, prepare_distributed_heat,
                   run_distributed_heat)
from .scan import (distributed_segmented_scan, make_iterated_sharded_scan,
                   make_iterated_sharded_scan_gated, shard_1d)

__all__ = [
    "Mesh",
    "make_mesh_1d",
    "make_mesh_2d",
    "mesh_for_method",
    "distributed_heat_step",
    "prepare_distributed_heat",
    "run_distributed_heat",
    "distributed_segmented_scan",
    "make_iterated_sharded_scan",
    "make_iterated_sharded_scan_gated",
    "shard_1d",
]
