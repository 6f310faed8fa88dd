"""Moosavi-style universal perturbation (iterated DeepFool).

Port of ``dl_attack_on_imagenet_tpu/attacks/universal_pert.py``: passes
over the training images in a shuffled order, folding in the DeepFool
increment of each image the current perturbation does not yet fool,
projected onto the lp ball of radius ``xi``, until the fooling rate on the
whole val set reaches ``1 - delta`` or ``max_iter_uni`` passes are done.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data import as_array_dataset
from ..models import VictimModel
from .fast_uap import fold_chunk, pad_chunk
from .uap_pgd import additive_fooling_rate


def universal_perturbation(
    data_train,
    data_val,
    victim: VictimModel,
    delta: float = 0.2,
    max_iter_uni: int = 100,
    xi: float = 20 / 255.0,
    p: str = "linf",
    num_classes: int = 10,
    overshoot: float = 0.02,
    max_iter_df: int = 10,
    seed: int = 0,
    verbose: bool = False,
    save_path: Optional[str] = None,
    chunk: int = 1,
) -> Tuple[torch.Tensor, list]:
    """Returns (the perturbation (H, W, C) on the victim's device, the
    fooling-rate history, one entry a pass).

    ``p`` is 'l2' or 'linf'. Each pass visits the images in the order of
    ``np.random.default_rng(seed).permutation(n)`` (one draw a pass), the
    JAX package's order from the same seed. ``chunk`` images at a time go
    through :func:`fast_uap.fold_chunk`; ``chunk=1`` is the reference's
    sequential trajectory. With ``save_path`` the perturbation is also
    written there with ``np.save``.
    """
    train = as_array_dataset(data_train)
    dev = victim.device
    images = torch.as_tensor(train.images, dtype=torch.float32, device=dev)
    val_images = torch.as_tensor(as_array_dataset(data_val).images, dtype=torch.float32,
                                 device=dev)
    n = len(train)
    v = torch.zeros(train.image_shape, device=dev)
    fooling_rate = 0.0
    history = []
    rng = np.random.default_rng(seed)
    n_iter = 0
    while fooling_rate < 1 - delta and n_iter < max_iter_uni:
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for s in range(0, n, chunk):
            x, valid = pad_chunk(images[order[s:s + chunk]], chunk)
            v = fold_chunk(victim, v, x, valid, num_classes, overshoot, max_iter_df, xi, p)
        fooling_rate = additive_fooling_rate(victim, v[None], val_images)
        history.append(fooling_rate)
        n_iter += 1
        if verbose:
            print(f"[universal_pert] iter {n_iter} fooling {fooling_rate:.3f}")
    if save_path:
        np.save(save_path, v.cpu().numpy())
    return v, history
