"""Fast-UAP: a universal perturbation accumulated from DeepFool increments.

Port of ``dl_attack_on_imagenet_tpu/attacks/fast_uap.py``. The outer loop
is sequential (image i+1's gate sees image i's fold), so it stays a Python
loop over chunks of images; each chunk's gate and DeepFool solve run
batched (:func:`fold_chunk`). Also ``deepfool_cosinus_batch`` and
``DeepFoolCosinus``: DeepFool stepping toward the decision boundary whose
displacement is most aligned with a given perturbation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import as_array_dataset
from ..models import VictimModel
from ..utils import ArtifactCache
from .base import Attack
from .deepfool import deepfool_batch, forward_with_graph, predict, selected_jacobian
from .uap_pgd import additive_fooling_rate, fold_increments


def pad_chunk(x: torch.Tensor, chunk: int):
    """A ragged tail of fewer than ``chunk`` rows padded with copies of its
    last row, and the mask of its real rows (None where nothing was
    padded). Every chunk then runs at one batch shape, as in the JAX
    package, and the padded rows are gated out."""
    pad = chunk - x.shape[0]
    if pad <= 0:
        return x, None
    valid = torch.arange(chunk, device=x.device) < x.shape[0]
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))]), valid


def fold_chunk(model, v: torch.Tensor, x: torch.Tensor, valid: Optional[torch.Tensor],
               num_classes: int, overshoot: float, max_iter: int, eps: float,
               norm: str) -> torch.Tensor:
    """One chunk of the per-image pass that Fast-UAP and
    ``universal_perturbation`` share: the rows that ``x + v`` leaves
    classified as ``x`` (and that are ``valid``) pass the gate, one
    lockstep DeepFool solves them from ``x + v``, and the increments of
    those that converged in fewer than ``max_iter - 1`` iterations fold
    into ``v`` in row order, projected after each. Returns the new ``v``;
    a chunk with no row through the gate costs one host read and no solve.
    """
    pert = x + v[None]
    gate = predict(model, x) == predict(model, pert)
    if valid is not None:
        gate = gate & valid
    if not bool(gate.any()):
        return v
    delta, iters = deepfool_batch(model, pert, num_classes, overshoot, max_iter,
                                  active_init=gate)
    accept = gate & (iters < max_iter - 1)
    return fold_increments(v, delta, accept, eps, norm)


class FastUAP(Attack):
    """Fast universal adversarial perturbation.

    Each epoch takes the training images in dataset order, ``chunk`` at a
    time (:func:`fold_chunk`, DeepFool over the top 10 classes for at most
    ``steps_deepfool`` iterations); with ``data_val`` it stops once the val
    fooling rate reaches ``fooling_rate``. ``chunk=1`` is the reference's
    sequential trajectory; a larger chunk gates each image against the
    chunk's starting perturbation. The artifact is ``FastUAP_model_<name>``
    with ``{"e": (1, H, W, C), "fooling_rate": f32[epochs with val]}``.
    """

    def __init__(
        self,
        victim: VictimModel,
        steps: int = 10,
        fooling_rate: float = 0.98,
        eps: float = np.inf,
        norm: str = "linf",
        data_train=None,
        data_val=None,
        overshoot: float = 0.02,
        steps_deepfool: int = 50,
        model_name: Optional[str] = None,
        cache: Optional[ArtifactCache] = None,
        chunk: int = 1,
        verbose: bool = False,
    ):
        super().__init__(victim, "FastUAP", targeted=False)
        self.steps = int(steps)
        self.target_fooling = fooling_rate
        self.eps = eps
        self.norm = norm.lower()
        self.overshoot = overshoot
        self.steps_deepfool = steps_deepfool
        self.model_name = model_name or victim.name
        self.cache = cache or ArtifactCache("trained_dicts")
        self.chunk = chunk
        self.verbose = verbose
        self.attack_vec: Optional[torch.Tensor] = None
        self.history: dict = {}

        if not self.cache.exists("FastUAP", model=self.model_name) and data_train is not None:
            self.learn_attack(data_train, data_val)

    @property
    def is_trained(self) -> bool:
        """Whether ``forward`` would skip its lazy learn."""
        return self.attack_vec is not None or self.cache.exists("FastUAP", model=self.model_name)

    @property
    def device(self) -> torch.device:
        return self.victim.device

    def learn_attack(self, data_train, data_val=None) -> None:
        """Learn the perturbation, save the artifact and keep it."""
        ds = as_array_dataset(data_train)
        images = torch.as_tensor(ds.images, dtype=torch.float32, device=self.device)
        attack = torch.zeros(ds.image_shape, device=self.device)
        val_images = None
        if data_val is not None:
            val_images = torch.as_tensor(as_array_dataset(data_val).images, dtype=torch.float32,
                                         device=self.device)
        fooling_rate = []
        for it in range(self.steps):
            for s in range(0, len(ds), self.chunk):
                x, valid = pad_chunk(images[s:s + self.chunk], self.chunk)
                attack = fold_chunk(self.victim, attack, x, valid, 10, self.overshoot,
                                    self.steps_deepfool, self.eps, self.norm)
            if val_images is not None:
                fooling_rate.append(additive_fooling_rate(self.victim, attack[None], val_images))
                if self.verbose:
                    print(f"[fastuap] epoch {it} val_fool {fooling_rate[-1]:.3f}")
                if fooling_rate[-1] >= self.target_fooling:
                    break
        self.attack_vec = attack[None]
        self.history = {"fooling_rate": fooling_rate}
        self.cache.save({"e": self.attack_vec, "fooling_rate": np.asarray(fooling_rate, np.float32)},
                        "FastUAP", model=self.model_name)

    def _load(self) -> torch.Tensor:
        if self.attack_vec is None:
            payload = self.cache.load("FastUAP", model=self.model_name)
            if payload is None:
                raise FileNotFoundError("Fast-UAP attack has not been learned")
            self.attack_vec = torch.as_tensor(payload["e"], dtype=torch.float32,
                                              device=self.device)
        return self.attack_vec

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not self.is_trained:
            self.learn_attack((images.detach().cpu().numpy(), labels.detach().cpu().numpy()),
                              None)
        return torch.clamp(images + self._load(), 0.0, 1.0)


def deepfool_cosinus_batch(
    model,
    images: torch.Tensor,
    attack_init: torch.Tensor,
    num_classes: int = 10,
    overshoot: float = 0.02,
    max_iter: int = 50,
) -> torch.Tensor:
    """DeepFool toward the boundary most aligned with ``attack_init``.

    Starting from ``clip(images + attack_init, 0, 1)``, at each step and
    for each active image: among the top ``num_classes`` classes, each
    boundary displacement is ``delta_k = |f_k| w_k / ||w_k||^2``; the one
    with the largest cosine with ``attack_init`` is taken, and the image
    steps by ``(1 + overshoot) delta_best``, clipped to [0, 1]. An image
    stays active while it keeps its clean label. Returns the adversarial
    images. ``attack_init`` is (H, W, C) or (1, H, W, C).
    """
    n = images.shape[0]
    with torch.no_grad():
        top_idx = torch.topk(model(images).float(), num_classes, dim=1).indices
    labels = top_idx[:, 0]
    a_flat = attack_init.reshape(-1)
    a_norm = torch.sqrt(torch.sum(a_flat ** 2) + 1e-24)
    start = images + (attack_init[None] if attack_init.dim() == images.dim() - 1 else attack_init)
    adv = torch.clamp(start, 0.0, 1.0)
    active = torch.ones(n, dtype=torch.bool, device=images.device)
    rows = torch.arange(n, device=images.device)
    for _ in range(max_iter):
        x, logits = forward_with_graph(model, adv)
        active = active & (torch.argmax(logits.detach(), -1) == labels)
        # As in deepfool_batch: with no row active, this step changes
        # nothing (the clip of a clipped image) and the loop ends after it.
        if not bool(active.any()):
            break
        jac = selected_jacobian(x, logits, top_idx)
        f = logits.detach().gather(1, top_idx)
        w = jac[:, 1:] - jac[:, :1]
        f_k = f[:, 1:] - f[:, :1]
        w_sq = torch.sum(w ** 2, dim=(2, 3, 4)) + 1e-24
        delta = (torch.abs(f_k) / w_sq)[:, :, None, None, None] * w
        d_flat = delta.reshape(n, delta.shape[1], -1)
        # An elementwise product and sum, so that no TF32 setting enters.
        cos = torch.sum(d_flat * a_flat, -1) / (
            torch.sqrt(torch.sum(d_flat ** 2, -1) + 1e-24) * a_norm)
        best = torch.argmax(cos, dim=1)
        step = (1.0 + overshoot) * delta[rows, best]
        adv = torch.clamp(adv + active[:, None, None, None].to(adv.dtype) * step, 0.0, 1.0)
    return adv


class DeepFoolCosinus(Attack):
    """Class wrapper over :func:`deepfool_cosinus_batch`."""

    def __init__(self, victim: VictimModel, steps: int = 50, overshoot: float = 0.02):
        super().__init__(victim, "DeepFoolCosinus", targeted=False)
        self.steps = steps
        self.overshoot = overshoot

    def forward(self, images: torch.Tensor, labels: torch.Tensor,
                attack_init: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attack_init is None:
            attack_init = torch.zeros(images.shape[1:], device=images.device)
        return deepfool_cosinus_batch(self.victim, images, attack_init,
                                      overshoot=self.overshoot, max_iter=self.steps)

    def __call__(self, images, labels=None, attack_init=None) -> torch.Tensor:
        images = torch.as_tensor(images, dtype=torch.float32, device=self.victim.device)
        if labels is None:
            labels = self.predict(images)
        if attack_init is not None:
            attack_init = torch.as_tensor(attack_init, dtype=torch.float32, device=images.device)
        return self.forward(images, torch.as_tensor(labels, device=images.device), attack_init)
