"""Import the reference's torch-pickle attack artifacts into ArtifactCache.

Port of ``dl_attack_on_imagenet_tpu/utils/import_reference.py``: the same
five kinds, the same layout conversions, the same cache keys and the same
payloads, so that either package's attack classes memoize against what
either package imported. The reference memoizes every trained attack as a
``torch.save``'d list:

- ADIL: ``[d (C,H,W,K), v (N,K), loss_all, fooling_rate_all, val_fool]``;
- ADILR: ``[D (C,H,W,K), label, pred, v, loss]`` from its solver functions,
  or the ADIL-style list from its class trainer;
- UAP-PGD and Fast-UAP: ``[attack (1,C,H,W), fooling_rate]``;
- the universal perturbation: a ``.npy`` of ``(1,C,H,W)`` or ``(C,H,W)``.

The reference is NCHW with an atoms-last dictionary ``(C, H, W, K)``; the
port keeps the JAX package's NHWC, atoms-first ``(K, H, W, C)``.
Perturbations convert ``(1,C,H,W) -> (1,H,W,C)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .checkpoint import ArtifactCache


def _load_torch_list(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # Reference artifacts may hold plain Python lists, floats or
        # autograd Variables that the restricted unpickler rejects. Only
        # load artifacts you trust.
        try:
            return torch.load(path, map_location="cpu", weights_only=False)
        except (ModuleNotFoundError, AttributeError) as e:
            # A pickled nn.Module (the reference's DDP save) needs the
            # reference package importable to unpickle.
            raise ValueError(
                f"{path}: unpickling needs the reference's own classes "
                f"({e}). DDP-trained artifacts pickle the whole "
                "Attack_dict_model module; re-save tensors from an "
                "environment where the reference imports: "
                "m, loss, fool = torch.load(path); "
                "torch.save([m.d.data, m.v.data, loss, fool, 0.0], path)"
            ) from e


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ref_dict_to_atoms_first(d: np.ndarray) -> np.ndarray:
    """Reference dictionary (C, H, W, K) -> the port's (K, H, W, C)."""
    if d.ndim != 4:
        raise ValueError(f"expected a 4-D dictionary, got shape {d.shape}")
    return np.ascontiguousarray(np.transpose(d, (3, 1, 2, 0)))


def ref_image_to_nhwc(e: np.ndarray) -> np.ndarray:
    """Reference perturbation (1, C, H, W) [or (C, H, W)] -> (1, H, W, C)."""
    if e.ndim == 3:
        e = e[None]
    if e.ndim != 4:
        raise ValueError(f"expected a (1,C,H,W) perturbation, got {e.shape}")
    return np.ascontiguousarray(np.transpose(e, (0, 2, 3, 1)))


def _unpack_dict_artifact(loaded, path: str):
    """Check and unpack a ``[d, v, ...curves]`` reference dictionary
    artifact; the DDP path's pickled module is refused with how to convert
    it."""
    if not isinstance(loaded, (list, tuple)) or len(loaded) < 2:
        raise ValueError(f"{path}: expected the reference's [d, v, ...] "
                         f"list, got {type(loaded).__name__}")
    if isinstance(loaded[0], torch.nn.Module):
        m = loaded[0]
        raise ValueError(
            f"{path}: DDP-format artifact (adil.py:428 pickles the whole "
            "module). Re-save its tensors first: torch.save([m.d.data, "
            f"m.v.data, *rest], path)  # m has d{tuple(m.d.shape) if hasattr(m, 'd') else ''}"
        )
    d = _to_np(loaded[0])
    v = _to_np(loaded[1])
    if d.ndim != 4 or v.ndim != 2 or v.shape[1] != d.shape[3]:
        raise ValueError(
            f"{path}: element 0/1 do not look like the reference's "
            f"d (C,H,W,K) + v (N,K): got {d.shape} and {v.shape}"
        )
    return d, v, list(loaded[2:])


def import_adil(path: str, cache: ArtifactCache, model_name: str) -> str:
    """Import an ADIL dictionary artifact; returns the cache path written.
    The payload is ``ADIL._save``'s, so ``ADIL(victim, model_name=...,
    cache=...)`` memoizes against it."""
    d, v, rest = _unpack_dict_artifact(_load_torch_list(path), path)
    loss_all = rest[0] if len(rest) > 0 else []
    fooling_all = rest[1] if len(rest) > 1 else []
    val_fool = rest[2] if len(rest) > 2 else None
    payload: Dict[str, Any] = {
        "d": ref_dict_to_atoms_first(d).astype(np.float32),
        "v": v.astype(np.float32),
        "loss": np.asarray(_to_np(loss_all), np.float64).ravel(),
        "fooling_rate": np.asarray(_to_np(fooling_all), np.float64).ravel(),
    }
    if val_fool is not None:
        payload["val_fooling"] = np.asarray(_to_np(val_fool), np.float64)
    return cache.save(payload, "ImageNet", model=model_name)


def import_adilr(
    path: str,
    cache: ArtifactCache,
    model_name: str,
    lam1: float,
    lam2: float,
    atoms: Optional[int] = None,
    steps: int = 100,
    tag: str = "param_selecting",
) -> str:
    """Import an ADILR artifact in either of the reference's formats,
    told apart by the shape of its second element: the solver functions'
    ``[D, label, pred, v, loss]`` or the class trainer's ADIL-style
    ``[d, v, loss_all, fooling_rate_all, val_fool]``. The cache key is
    ``ADILR``'s (model, lam1, lam2, atoms, steps, tag); ``atoms`` defaults
    to the dictionary's K."""
    loaded = _load_torch_list(path)
    if not isinstance(loaded, (list, tuple)) or len(loaded) < 2:
        raise ValueError(f"{path}: expected a reference ADILR list artifact")
    e1 = _to_np(loaded[1])
    if e1.ndim == 2:
        d, v, rest = _unpack_dict_artifact(loaded, path)
        loss = rest[0] if rest else []
        labels = None
    elif len(loaded) >= 5:
        d, label, _pred, v_t, loss = loaded[:5]
        d, v, labels = _to_np(d), _to_np(v_t), np.asarray(_to_np(label)).ravel()
        if d.ndim != 4 or v.ndim != 2 or v.shape[1] != d.shape[3]:
            raise ValueError(
                f"{path}: elements do not match [D (C,H,W,K), label, pred, "
                f"v (N,K), loss]: d {d.shape}, v {v.shape}"
            )
    else:
        raise ValueError(
            f"{path}: unrecognized ADILR artifact — expected "
            "[D, label, pred, v, loss] (adil_regularized.py:499) or "
            "[d, v, loss, fooling, val_fool] (:815)"
        )
    d_np = ref_dict_to_atoms_first(d).astype(np.float32)
    payload = {
        "d": d_np,
        "v": v.astype(np.float32),
        "loss": np.asarray(_to_np(loss), np.float32).ravel(),
    }
    if labels is not None:
        payload["labels"] = labels
    key = dict(model=model_name, lam1=lam1, lam2=lam2,
               atoms=int(atoms if atoms is not None else d_np.shape[0]),
               steps=int(steps), tag=tag)
    return cache.save(payload, "ADILR", **key)


def import_uap(path: str, cache: ArtifactCache, model_name: str,
               kind: str = "UAPPGD") -> str:
    """Import a UAP-PGD or Fast-UAP artifact (``[attack, fooling_rate]``)
    under the prefix ``kind``, "UAPPGD" or "FastUAP"."""
    if kind not in ("UAPPGD", "FastUAP"):
        raise ValueError(f"kind must be UAPPGD or FastUAP, got {kind!r}")
    loaded = _load_torch_list(path)
    e, fooling = loaded[0], loaded[1] if len(loaded) > 1 else []
    payload = {
        "e": ref_image_to_nhwc(_to_np(e)).astype(np.float32),
        "fooling_rate": np.asarray(_to_np(fooling), np.float32).ravel(),
    }
    return cache.save(payload, kind, model=model_name)


def import_universal(path: str, save_path: str) -> str:
    """Convert the universal perturbation's ``.npy`` ((1,C,H,W) or (C,H,W))
    to the (H,W,C) array that ``attacks.universal_perturbation`` saves.
    Returns the path written (``.npy`` appended where missing, as
    ``np.save`` does)."""
    v = ref_image_to_nhwc(np.asarray(np.load(path)))[0]
    if not save_path.endswith(".npy"):
        save_path = save_path + ".npy"
    np.save(save_path, v.astype(np.float32))
    return save_path
