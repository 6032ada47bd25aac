"""The device mesh (port of unilm_tpu/parallel/mesh.py).

One mesh with JAX's six named axes over the ranks of the current
`torch.distributed` process group, built with
`torch.distributed.device_mesh.init_device_mesh`:

- stage:  pipeline stages (parallel/pipeline.py);
- data:   data parallelism (gradients averaged over data x fsdp);
- fsdp:   parameter sharding (ZeRO-3; parallel/sharding.py);
- tensor: tensor parallelism (column / row projections);
- expert: MoE expert parallelism (core/moe.py);
- seq:    sequence parallelism (parallel/ring_attention.py,
          parallel/long_context.py).

Ranks fill the mesh in row-major order of MESH_AXES, as JAX reshapes its
device list. The caller initialises the process group (a
`tcp://localhost:<port>` or `file://` init method, world size and rank:
nothing tells a program of a cluster); the device type is the one of the
group's backend ("cuda" for NCCL, "cpu" for gloo).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("stage", "data", "fsdp", "tensor", "expert", "seq")


def mesh_sizes(axis_sizes: Optional[Mapping[str, int]], n: int) -> dict:
    """The size of every axis for n ranks: unspecified axes are 1, one
    axis may be -1 to take the remaining ranks; JAX's errors."""
    sizes = dict.fromkeys(MESH_AXES, 1)
    for k, v in (axis_sizes or {}).items():
        if k not in sizes:
            raise ValueError(f"unknown mesh axis {k!r}; use {MESH_AXES}")
        sizes[k] = v
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("only one axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by {fixed}")
        sizes[wild[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {n}")
    return sizes


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None, *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh with the dims MESH_AXES over every rank of the default
    process group (which must be initialised)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    sizes = mesh_sizes(axis_sizes, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes[a] for a in MESH_AXES),
                            mesh_dim_names=MESH_AXES)


def data_parallel_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    return make_mesh({"data": -1}, device_type=device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis `name` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1
