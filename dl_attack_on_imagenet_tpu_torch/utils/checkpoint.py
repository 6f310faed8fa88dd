"""Artifact persistence: trained dictionaries and result dicts.

Port of the msgpack backend of ``dl_attack_on_imagenet_tpu/utils/checkpoint.py``:
the same path scheme and the same bytes, so that an artifact written by
either package loads in the other. The orbax and sharded backends are not
ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

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


class ArtifactCache:
    """Deterministic artifact paths keyed by attack hyper-parameters.

    ``ArtifactCache(root).path("ImageNet", model="resnet50")`` is
    ``root/ImageNet_model_resnet50.msgpack``.
    """

    def __init__(self, root: str = "trained_dicts", backend: str = "msgpack"):
        if backend != "msgpack":
            raise NotImplementedError(f"the {backend!r} backend is not ported yet")
        self.root = root
        self.backend = backend

    def path(self, prefix: str, **hyper: Any) -> str:
        parts = [prefix] + [f"{k}_{hyper[k]}" for k in sorted(hyper)]
        return os.path.join(self.root, "_".join(str(p) for p in parts) + ".msgpack")

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
