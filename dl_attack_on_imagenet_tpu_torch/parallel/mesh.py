"""The device mesh: one device per rank, on a 1-D ``'data'`` axis."""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .dist import current_device


def local_devices() -> List[torch.device]:
    """The devices this process sees: its cards, else the CPU."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> DeviceMesh:
    """A 1-D mesh over every rank of the initialized process group
    (``dist.auto_initialize``), one device per rank
    (``dist.current_device``).

    Images and per-image codes shard along the axis; D, about 15M floats at
    224², replicates. ``n_devices`` other than the world size raises.
    """
    if not dist.is_initialized():
        raise RuntimeError("data_mesh needs a process group: call parallel.auto_initialize() first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, have {world} ranks")
    return init_device_mesh(current_device().type, (world,), mesh_dim_names=(axis_name,))
