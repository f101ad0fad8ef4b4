"""Multi-device training and evaluation: the ('data', 'model') mesh and its
sharding rules (mesh.py), the process launcher (launch.py) and the
multi-device dry run (dryrun.py)."""

from forest_slam_tpu_torch.parallel.mesh import batch_shardings, make_mesh, mesh_shape, param_shardings, replicated

__all__ = ["make_mesh", "mesh_shape", "param_shardings", "batch_shardings", "replicated"]
