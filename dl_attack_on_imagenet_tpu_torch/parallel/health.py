"""Mesh health check.

The reference has no failure detection: a hung NCCL rank deadlocks the
job. Port of ``dl_attack_on_imagenet_tpu/parallel/health.py``: one
collective round trip that shows every rank computes and communicates,
run before a long training job.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .dist import current_device


def check_mesh(mesh: DeviceMesh, axis: str = "data") -> dict:
    """All-reduce ``rank + 1`` over ``mesh``'s axis.

    Returns {'ok': bool, 'n_devices': int, 'psum': float, 'expected': float}
    (with 'error' instead of 'psum' where the collective raised). Raises
    nothing: callers decide what ``ok: False`` means.
    """
    n = mesh.size()
    group = mesh.get_group(axis)
    try:
        x = torch.full((1,), float(dist.get_rank(group) + 1), device=current_device())
        dist.all_reduce(x, group=group)
        total, expected = float(x[0]), float(n * (n + 1) / 2)
        return {"ok": total == expected, "n_devices": n, "psum": total, "expected": expected}
    except Exception as e:  # a device or transport failure
        return {"ok": False, "n_devices": n, "error": str(e)}
