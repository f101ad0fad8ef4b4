"""Device mesh and sharding rules (port of parallel/mesh.py).

The JAX package is single-controller: one process, a mesh of devices, and
GSPMD inserts the collectives from the shardings. PyTorch is
multi-controller: one process per rank, a rank plays the part of a JAX
device, and the collectives are explicit. Every function of the parallel
path is called on every rank with the same arguments, as a JAX program is
traced once, and every rank returns the same replicated result.

- ``data`` axis: the batch (data parallelism) of front-end training and
  the sequence axis of batched multi-sequence evaluation;
- ``model`` axis: the output-feature dimension of the SuperPoint and
  SuperGlue Dense/Conv kernels, held as ``1/model`` shards on each rank.

Shardings are ``torch.distributed.tensor`` placements (``Replicate()``,
``Shard(dim)``) keyed by parameter name.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

from forest_slam_tpu_torch.frontend.params import Dense

AXES = ("data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) of an n-device mesh: the model axis gets the largest of
    4 and 2 that divides n (SuperGlue's 4 heads bound the useful TP width),
    the rest is data; 1 device gives (1, 1)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    model = next((c for c in (4, 2) if n % c == 0 and n >= c), 1)
    return n // model, model


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no mesh on {kind!r} devices; use 'cuda' or 'cpu'")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA card and none is available; pass device='cpu' for gloo ranks "
                           "on the CPU")
    return kind


def _one_rank_group(kind: str) -> None:
    """A one-rank default group from a FileStore in a temporary directory
    (no TCP port, so concurrent processes cannot clash), torn down at exit:
    the group first (an NCCL group left up outlives its store and stalls
    the interpreter's exit), then the directory."""
    path = tempfile.mkdtemp(prefix="fs_mesh_")
    atexit.register(_teardown, path)
    dist.init_process_group(BACKENDS[kind], store=dist.FileStore(os.path.join(path, "store"), 1), rank=0,
                            world_size=1)


def _teardown(path: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(path, True)


def make_mesh(n_devices: int | None = None, device="cuda") -> DeviceMesh:
    """2-D ('data', 'model') mesh over every rank of the default process
    group, shaped by :func:`mesh_shape`. The backend is nccl for 'cuda' and
    gloo for 'cpu'. Without a default group it starts a one-rank one
    (``n_devices`` must then be 1); with one, ``n_devices`` must be its
    size (parallel/launch.py starts n ranks). Asking for 'cuda' without a
    card raises."""
    kind = _device_type(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"{n_devices} devices asked for in a single process; start the ranks with "
                             "forest_slam_tpu_torch.parallel.launch")
        _one_rank_group(kind)
    if dist.get_backend() != BACKENDS[kind]:
        raise ValueError(f"a {kind} mesh needs the {BACKENDS[kind]} backend, the default group runs "
                         f"{dist.get_backend()}")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices asked for on {n} ranks")
    return init_device_mesh(kind, mesh_shape(n), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicated(mesh: DeviceMesh) -> Placement:
    return Replicate()


def flax_out_dim(owner: nn.Module, leaf: str, p: torch.Tensor) -> int | None:
    """The torch dim of a Flax "kernel" leaf's last (output-feature) dim, or
    None when the parameter is no kernel. The port keeps Flax's name and
    layout for ``Dense`` (kernel (in, out): dim -1); an ``nn.Linear`` weight
    is (out, in) and an ``nn.Conv2d`` weight (out, in, kh, kw), so their
    Flax last dim is torch dim 0."""
    if isinstance(owner, Dense) and leaf == "kernel":
        return p.ndim - 1
    if isinstance(owner, (nn.Linear, nn.Conv2d)) and leaf == "weight":
        return 0
    return None


def _is_tp_shardable(owner: nn.Module, leaf: str, p: torch.Tensor, model_size: int) -> int | None:
    """parallel/mesh.py's rule: only kernels of ndim >= 2 whose output
    features divide by ``model_size`` and number at least ``2 * model_size``;
    the dim to shard, or None."""
    dim = flax_out_dim(owner, leaf, p)
    if dim is None or p.ndim < 2:
        return None
    out = p.shape[dim]
    return dim if out % model_size == 0 and out >= 2 * model_size else None


def param_shardings(module: nn.Module, mesh: DeviceMesh) -> dict[str, Placement]:
    """Tensor-parallel placements by parameter name: the kernels
    :func:`_is_tp_shardable` admits are ``Shard(dim)`` over 'model' on
    their output-feature dim; everything else (biases, norms, scalars) is
    ``Replicate()``."""
    model_size = mesh.size(AXES.index("model"))
    out = {}
    for mod_name, owner in module.named_modules():
        for leaf, p in owner.named_parameters(recurse=False):
            dim = _is_tp_shardable(owner, leaf, p, model_size) if model_size > 1 else None
            out[f"{mod_name}.{leaf}" if mod_name else leaf] = Replicate() if dim is None else Shard(dim)
    return out


def batch_shardings(batch, mesh: DeviceMesh):
    """``Shard(0)`` over 'data' for every tensor of ``batch`` (a NamedTuple
    or tuple of tensors), in its structure."""
    placements = [Shard(0) for _ in batch]
    return type(batch)(*placements) if hasattr(batch, "_fields") else type(batch)(placements)
