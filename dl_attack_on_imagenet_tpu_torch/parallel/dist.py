"""Launcher discovery and the process group.

Port of ``dl_attack_on_imagenet_tpu/parallel/dist.py``. Discovery is lazy:
nothing is read at import. The SLURM variables keep the JAX package's
meaning (``SLURM_NTASKS``, ``SLURM_PROCID``, the first host of
``SLURM_JOB_NODELIST``, plus ``SLURM_LOCALID``), and torch's own launcher
variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, what ``torchrun`` sets) take the place of the ``JAX_*``
ones and win over SLURM's.
"""

from __future__ import annotations

import dataclasses
import os
import re
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device

DEFAULT_PORT = "12345"


@dataclasses.dataclass(frozen=True)
class DistributedEnv:
    coordinator: Optional[str]
    num_processes: int
    process_id: int
    local_rank: int = 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def distributed_env() -> DistributedEnv:
    """Read the launcher environment (torch's variables, else SLURM's).

    The coordinator is ``MASTER_ADDR:MASTER_PORT``; under SLURM without
    ``MASTER_ADDR`` it is the nodelist's first host on ``MASTER_PORT`` (by
    default 12345); otherwise None.
    """
    env = os.environ
    num = int(env.get("WORLD_SIZE", env.get("SLURM_NTASKS", "1")))
    pid = int(env.get("RANK", env.get("SLURM_PROCID", "0")))
    local = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0")))
    port = env.get("MASTER_PORT", DEFAULT_PORT)
    if "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{port}"
    elif "SLURM_JOB_NODELIST" in env:
        coordinator = f"{expand_first_host(env['SLURM_JOB_NODELIST'])}:{port}"
    else:
        coordinator = None
    return DistributedEnv(coordinator, num, pid, local)


def expand_first_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, with bracket-range expansion:
    'node[001-004,007],other[1-2]' -> 'node001'."""
    nodelist = nodelist.strip()
    m = re.match(r"([^,\[]*)\[([^\]]*)\]", nodelist)
    if not m:
        return nodelist.split(",")[0]
    prefix, ranges = m.group(1), m.group(2)
    return f"{prefix}{ranges.split(',')[0].split('-')[0]}"


def rank_device(device: DeviceLike = None, env: Optional[DistributedEnv] = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``cuda`` (the default; it
    raises where there is no card) or a bare ``cuda``, else the device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (env or distributed_env()).local_rank)
    return dev


_rank_device: Optional[torch.device] = None


def current_device() -> torch.device:
    """This rank's device: the one :func:`auto_initialize` set up, or, for a
    process group made elsewhere, the current card under NCCL, else the CPU."""
    if _rank_device is not None:
        return _rank_device
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def auto_initialize(env: Optional[DistributedEnv] = None, device: DeviceLike = None,
                    backend: Optional[str] = None) -> DistributedEnv:
    """Initialize the default process group once, and return the environment.

    The backend is NCCL when this rank's device (:func:`rank_device`) is
    CUDA, after ``torch.cuda.set_device`` to it, and gloo on the CPU;
    ``backend`` overrides it (gloo also takes CUDA tensors, which puts
    several ranks on one card). Without launcher variables the world is
    this one process, on a free local port, so a distributed entry point
    also runs as one plain process.
    """
    global _rank_device
    env = env or distributed_env()
    if dist.is_initialized():
        return env
    dev = rank_device(device, env)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    coordinator = env.coordinator
    if coordinator is None:
        if env.is_distributed:
            raise RuntimeError(f"a world of {env.num_processes} processes needs MASTER_ADDR "
                               "(or SLURM_JOB_NODELIST) to meet")
        coordinator = f"localhost:{_free_port()}"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator}",
                            world_size=env.num_processes, rank=env.process_id)
    _rank_device = dev
    return env


def shutdown() -> None:
    """Destroy the default process group, where there is one."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None
