"""The agreement step and the pipelined engine (counterpart of ``ba_tpu.parallel``),
and their several-device forms: meshes, sharded sweeps, the node-sharded
protocols and the process group."""

from ba_tpu_torch.parallel.eig_parallel import eig_node_sharded
from ba_tpu_torch.parallel.mesh import make_mesh
from ba_tpu_torch.parallel.multihost import init_distributed, make_global_mesh, put_global
from ba_tpu_torch.parallel.node_parallel import om1_node_sharded
from ba_tpu_torch.parallel.sm_parallel import sm_node_sharded
from ba_tpu_torch.parallel.sweep import sharded_sweep

__all__ = [
    "eig_node_sharded",
    "init_distributed",
    "make_global_mesh",
    "make_mesh",
    "om1_node_sharded",
    "put_global",
    "sharded_sweep",
    "sm_node_sharded",
]
