"""The device mesh, on `torch.distributed`.

Counterpart of `videocof_tpu/parallel/mesh.py`: one ('data', 'seq', 'model')
mesh. ``data`` carries per-item data parallelism and FSDP weight sharding,
``seq`` Ulysses or ring sequence parallelism, ``model`` Megatron tensor
parallelism (`parallel.tp`). Each process is one rank; the process group
must be initialized first (`serving.multihost.init_distributed`, or
``torch.distributed.run``'s environment).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "seq", "model")


def rank_device() -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK mod the card count>`` (two
    ranks on one card share cuda:0). Without CUDA it raises RuntimeError."""
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no CUDA device on this rank")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``mesh``'s axis named ``axis`` (KeyError for an unknown
    name)."""
    if axis not in mesh.mesh_dim_names:
        raise KeyError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def make_mesh(data: int = 1, seq: int = 1, model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """The ('data', 'seq', 'model') mesh over the world's ranks: rank
    ``r = (d * seq + s) * model + m`` sits at ``(d, s, m)``, ``model``
    innermost, as JAX's device order. It raises ValueError unless ``data *
    seq * model`` is the world size. ``device_type``: "cuda" when CUDA is
    present, else "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(serving.multihost.init_distributed)")
    need, world = data * seq * model, dist.get_world_size()
    if need != world:
        raise ValueError(f"mesh {data}x{seq}x{model} needs {need} ranks, the "
                         f"world has {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, seq, model),
                            mesh_dim_names=AXES)
