"""DeepFool: minimal-l2 perturbation by linearized decision boundaries.

Port of ``dl_attack_on_imagenet_tpu/attacks/deepfool.py``: the whole batch
advances in lockstep under an active mask, as JAX's ``lax.while_loop``
does, and each step takes the k-class Jacobian of the whole batch from one
forward and k backward passes (:func:`selected_jacobian`). The loop's
condition, ``any(active)``, is one host read an iteration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import VictimModel
from .base import Attack


@torch.no_grad()
def predict(model, x: torch.Tensor) -> torch.Tensor:
    """Hard labels, ``argmax`` of the fp32 logits."""
    return torch.argmax(model(x).float(), -1)


def forward_with_graph(model, x: torch.Tensor):
    """``x`` as a new leaf that requires grad, and the fp32 logits at it
    with their graph, for :func:`selected_jacobian`."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        return x, model(x).float()


def selected_jacobian(x: torch.Tensor, logits: torch.Tensor,
                      top_idx: torch.Tensor) -> torch.Tensor:
    """The Jacobian (N, k, H, W, C) of each image's selected logits
    ``logits[i, top_idx[i, j]]`` with respect to that image alone, JAX's
    ``vmap(jacrev)`` of one image's logits, from the graph of
    :func:`forward_with_graph`.

    It takes k backward passes of the one batched forward, the j-th of
    ``sum_i logits[i, top_idx[i, j]]``. The victim runs in inference mode
    (BatchNorm on its running statistics, no dropout), so no row of the
    batch depends on another, and the gradient of that sum with respect to
    ``x_i`` is the gradient of ``logits[i, top_idx[i, j]]`` alone: row i of
    the j-th pass is row j of image i's Jacobian. This is preferred to
    ``torch.func.vmap(jacrev)`` and to ``is_grads_batched``, which can fall
    back to per-sample loops over cuDNN convolutions.
    """
    k = top_idx.shape[1]
    with torch.enable_grad():
        selected = logits.gather(1, top_idx)
        rows = [torch.autograd.grad(selected[:, j].sum(), x, retain_graph=j < k - 1)[0]
                for j in range(k)]
    return torch.stack(rows, 1)


def deepfool_batch(
    model,
    images: torch.Tensor,
    num_classes: int = 10,
    overshoot: float = 0.02,
    max_iter: int = 10,
    active_init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched DeepFool.

    Args:
      images: (N, H, W, C) in [0, 1].
      num_classes: the number of top logits to linearize against, the
        clean label first.
      active_init: optional (N,) bool mask; rows starting False never
        iterate and return (0, 0), so a caller can solve a gated subset of
        a chunk without the other rows lengthening the lockstep loop.

    Returns:
      (r_tot, iters): the accumulated perturbations (N, H, W, C) scaled by
      (1 + overshoot), and each image's iteration count (int32).
    """
    n = images.shape[0]
    with torch.no_grad():
        top_idx = torch.topk(model(images).float(), num_classes, dim=1).indices
    labels = top_idx[:, 0]
    r_tot = torch.zeros_like(images)
    active = (torch.ones(n, dtype=torch.bool, device=images.device) if active_init is None
              else torch.as_tensor(active_init, dtype=torch.bool, device=images.device))
    iters = torch.zeros(n, dtype=torch.int32, device=images.device)
    for _ in range(max_iter):
        pert = images + (1.0 + overshoot) * r_tot
        x, logits = forward_with_graph(model, pert)
        active = active & (torch.argmax(logits.detach(), -1) == labels)
        # JAX's loop tests any(active) before its next step: once no row is
        # active, this step changes nothing and the loop ends after it.
        if not bool(active.any()):
            break
        jac = selected_jacobian(x, logits, top_idx)
        f = logits.detach().gather(1, top_idx)
        w = jac[:, 1:] - jac[:, :1]
        f_k = f[:, 1:] - f[:, :1]
        w_norm = torch.sqrt(torch.sum(w ** 2, dim=(2, 3, 4)) + 1e-24)
        pert_k = torch.abs(f_k) / w_norm
        best = torch.argmin(pert_k, dim=1)
        rows = torch.arange(n, device=images.device)
        w_best = w[rows, best]
        pert_best = pert_k[rows, best]
        w_best_norm = torch.sqrt(torch.sum(w_best ** 2, dim=(1, 2, 3), keepdim=True) + 1e-24)
        r_i = (pert_best[:, None, None, None] + 1e-4) * w_best / w_best_norm
        r_tot = r_tot + active[:, None, None, None].to(r_i.dtype) * r_i
        iters += active.to(iters.dtype)
    return (1.0 + overshoot) * r_tot, iters


class DeepFool(Attack):
    """Attack-class wrapper over :func:`deepfool_batch`."""

    def __init__(self, victim: VictimModel, num_classes: int = 10, overshoot: float = 0.02,
                 steps: int = 10):
        super().__init__(victim, "DeepFool", targeted=False)
        self.num_classes = num_classes
        self.overshoot = overshoot
        self.steps = steps

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        r_tot, _ = deepfool_batch(self.victim, images, self.num_classes, self.overshoot,
                                  self.steps)
        return torch.clamp(images + r_tot, 0.0, 1.0)
