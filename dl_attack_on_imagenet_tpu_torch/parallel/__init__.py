"""Distributed runtime over ``torch.distributed``.

Port of ``dl_attack_on_imagenet_tpu/parallel``: launcher discovery and the
process group (``dist``), a 1-D mesh with a ``'data'`` axis over the ranks
(``mesh``), a collective health check (``health``) and data-parallel ADiL
dictionary learning (``adil_dp``). Collectives run over NCCL between CUDA
ranks and over gloo on the CPU; the code issues only ``all_reduce`` and
``broadcast`` on device tensors, which both backends take.
"""

from .adil_dp import learn_dictionary_distributed, make_dp_epoch_fn
from .dist import auto_initialize, distributed_env
from .health import check_mesh
from .mesh import data_mesh, local_devices

__all__ = [
    "data_mesh",
    "local_devices",
    "auto_initialize",
    "distributed_env",
    "learn_dictionary_distributed",
    "make_dp_epoch_fn",
    "check_mesh",
]
