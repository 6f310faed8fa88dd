"""Artifact persistence: trained dictionaries and result dicts.

Port of ``dl_attack_on_imagenet_tpu/utils/checkpoint.py``. The msgpack
backend keeps the same path scheme and the same bytes, so that an artifact
written by either package loads in the other.

The JAX package's ``backend="orbax"`` writes orbax ``StandardCheckpointer``
directories (OCDBT over tensorstore), which nothing but orbax reads or
writes; the port refuses it. Its ``save_sharded``/``load_sharded`` (the
collective orbax saves that keep row-sharded leaves where they are) are
ported onto torch's own sharding-aware checkpoint,
``torch.distributed.checkpoint`` (DCP), under ``.dcp_sharded``: each rank
writes and reads its own rows of a ``DTensor``. The JAX package cannot read
a DCP directory, nor the port an orbax one; msgpack stays the format the two
packages exchange.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import msgpack_codec


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_artifact(path: str, payload: Dict[str, Any]) -> None:
    """Serialize a dict of tensors/arrays/scalars to ``path`` (msgpack)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack_codec.pack(_to_host(payload))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_artifact(path: str) -> Optional[Dict[str, Any]]:
    """Load a payload saved by :func:`save_artifact` (numpy leaves); None
    if missing."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return msgpack_codec.unpack(f.read())


# ---------------------------------------------------------------------------
# torch.distributed.checkpoint directories
# ---------------------------------------------------------------------------


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    """(DCP's dotted name, leaf) of each leaf of a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def _replace_dir(src: str, dst: str) -> None:
    """Move the finished directory ``src`` to ``dst``. An older ``dst`` is
    set aside as ``dst.old`` first and removed last, so that a kill at any
    point leaves a whole checkpoint at ``dst`` or, between the two renames,
    at ``dst.old`` (:func:`_settled`)."""
    old = dst + ".old"
    if os.path.isdir(dst):
        shutil.rmtree(old, ignore_errors=True)
        os.replace(dst, old)
    os.replace(src, dst)
    shutil.rmtree(old, ignore_errors=True)


def _settled(path: str) -> Optional[str]:
    """The whole checkpoint directory that ``path`` names: ``path``, else
    the ``path.old`` that a kill between :func:`_replace_dir`'s renames left,
    else None."""
    for p in (path, path + ".old"):
        if os.path.isdir(p):
            return p
    return None


def _barrier() -> None:
    """``dist.barrier`` on the default group, on this rank's card under
    NCCL (none without a group)."""
    if dist.is_initialized():
        dist.barrier(device_ids=[torch.cuda.current_device()]
                     if dist.get_backend() == "nccl" else None)


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class ArtifactCache:
    """Deterministic artifact paths keyed by attack hyper-parameters.

    ``ArtifactCache(root).path("ImageNet", model="resnet50")`` is
    ``root/ImageNet_model_resnet50.msgpack``.
    """

    def __init__(self, root: str = "trained_dicts", backend: str = "msgpack"):
        if backend == "orbax":
            raise NotImplementedError(
                "the 'orbax' backend writes orbax StandardCheckpointer directories, which "
                "only orbax (a JAX library) reads or writes; use backend=\"msgpack\", the "
                "format both packages read, and for the sharded checkpoint of a data-parallel "
                "run learn_dictionary_distributed(ckpt_sharded=True), which writes "
                "torch.distributed.checkpoint directories")
        if backend != "msgpack":
            raise ValueError(f"backend must be 'msgpack' or 'orbax', got {backend!r}")
        self.root = root
        self.backend = backend

    def _stem(self, prefix: str, **hyper: Any) -> str:
        parts = [prefix] + [f"{k}_{hyper[k]}" for k in sorted(hyper)]
        return os.path.join(self.root, "_".join(str(p) for p in parts))

    def path(self, prefix: str, **hyper: Any) -> str:
        return self._stem(prefix, **hyper) + ".msgpack"

    def load(self, prefix: str, **hyper: Any) -> Optional[Dict[str, np.ndarray]]:
        return load_artifact(self.path(prefix, **hyper))

    def save(self, payload: Dict[str, Any], prefix: str, **hyper: Any) -> str:
        p = self.path(prefix, **hyper)
        save_artifact(p, payload)
        return p

    def exists(self, prefix: str, **hyper: Any) -> bool:
        return os.path.exists(self.path(prefix, **hyper))

    def remove(self, prefix: str, **hyper: Any) -> None:
        p = self.path(prefix, **hyper)
        if os.path.exists(p):
            os.remove(p)

    # ------------------------------------------------------------------
    # Sharding-aware (collective) checkpoints.
    #
    # The flat path gathers every leaf to one process. These methods keep
    # row-sharded leaves as ``DTensor``s over the caller's mesh: DCP writes
    # each rank's rows from where they are and one copy of each plain
    # (replicated) tensor, and restores into the live tensors of a
    # template, each rank reading only its own rows. EVERY rank of the
    # default process group must call them, and the path must be on a
    # filesystem all ranks share.
    # ------------------------------------------------------------------

    def _sharded_path(self, prefix: str, **hyper: Any) -> str:
        return self._stem(prefix, **hyper) + ".dcp_sharded"

    def save_sharded(self, tree: Dict[str, Any], prefix: str, **hyper: Any) -> str:
        """Collective DCP save of a nested dict of tensors and ``DTensor``s,
        through a temporary directory that rank 0 moves into place once
        every rank has written."""
        import torch.distributed.checkpoint as dcp

        p = os.path.abspath(self._sharded_path(prefix, **hyper))
        tmp = p + ".tmp"
        if _is_rank0():
            os.makedirs(os.path.dirname(p), exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier()
        dcp.save(tree, checkpoint_id=tmp, no_dist=not dist.is_initialized())
        if _is_rank0():
            _replace_dir(tmp, p)
        _barrier()
        return p

    def load_sharded(self, template: Dict[str, Any], prefix: str, **hyper: Any):
        """Collective restore into the tensors and ``DTensor``s of
        ``template`` (a nested dict of them), in place; returns
        ``template``, or None without a checkpoint (a save killed between
        its renames left the previous one as ``.old``, which is read then).
        The shapes are the
        template's: a checkpoint of other shapes (another world size's
        padded rows) raises."""
        import torch.distributed.checkpoint as dcp

        p = _settled(os.path.abspath(self._sharded_path(prefix, **hyper)))
        if p is None:
            return None
        saved = dcp.FileSystemReader(p).read_metadata().state_dict_metadata
        for fqn, leaf in _leaves(template):
            size = getattr(saved.get(fqn), "size", None)
            if size != leaf.shape:
                raise ValueError(f"{p}: {fqn!r} was saved as {size}, the template holds "
                                 f"{tuple(leaf.shape)}; a sharded checkpoint restores only at "
                                 "the shapes (and world size) that wrote it")
        dcp.load(template, checkpoint_id=p, no_dist=not dist.is_initialized())
        return template

    def exists_sharded(self, prefix: str, **hyper: Any) -> bool:
        return _settled(self._sharded_path(prefix, **hyper)) is not None

    def remove_sharded(self, prefix: str, **hyper: Any) -> None:
        """Delete a sharded checkpoint (with any ``.old`` or ``.tmp`` a
        killed save left): every rank waits, rank 0 removes, every rank
        waits again."""
        _barrier()
        if _is_rank0():
            p = self._sharded_path(prefix, **hyper)
            for q in (p, p + ".old", p + ".tmp"):
                shutil.rmtree(q, ignore_errors=True)
        _barrier()
