"""ADiL functional core, serving half: attacks with a frozen dictionary.

Port of the inference half of ``dl_attack_on_imagenet_tpu/attacks/adil_core.py``.
A ``model`` here is any callable from NHWC [0, 1] images to logits, such as
a ``VictimModel``. JAX's ``while_loop``/``scan`` become Python loops; the
early stop on ``max|Δ| < tol`` reads one scalar back to the host per step.

Every adversary that leaves a solver goes through the ``fused_perturb``
kernel: once per unsupervised trial, and once for each supervised solver's
final read-off with ``eps = inf`` (``clip(x + D v, 0, 1)``). The in-loop
forwards need gradients and stay plain torch, as the kernel has no backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from ..ops import (
    attack_loss,
    codes_from_pinv,
    dict_apply,
    dict_pinv,
    fused_perturb,
    linf_clamp,
    project_codes,
    project_dictionary,
)

Model = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdilConfig:
    """Static attack hyper-parameters (the reference operating point)."""

    eps: float = 8 / 255
    norm: str = "linf"  # 'linf' | 'l2'
    n_atoms: int = 100
    loss: str = "ce"  # 'ce' | 'logits'
    kappa: float = 50.0
    targeted: bool = False
    step_size: float = 0.01
    steps: int = 500
    steps_inner: int = 1
    batch_size: int = 100
    trials: int = 10
    steps_inference: int = 30
    steps_code: int = 100  # inner v-solver iterations
    code_lr: float = 1e-2  # inference-time AdamW lr
    tol: float = 1e-6
    perturb_dtype: str = "float32"

    def __post_init__(self):
        if self.perturb_dtype != "float32":
            raise NotImplementedError(
                f"perturb_dtype={self.perturb_dtype!r} is not ported yet; "
                "the port computes the perturbation in float32")

    @property
    def coeff(self) -> float:
        return 1.0 if self.targeted else -1.0


def init_dictionary(generator: torch.Generator, image_shape, cfg: AdilConfig,
                    device=None) -> torch.Tensor:
    """D init: linf -> U(-1, 1); l2 -> unit-ball-projected Gaussian.

    ``device`` defaults to the generator's.
    """
    shape = (cfg.n_atoms,) + tuple(image_shape)
    device = generator.device if device is None else device
    if cfg.norm == "l2":
        return project_dictionary(
            torch.randn(shape, generator=generator, device=device), "l2")
    return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0


def make_optimizer(params: Iterable[torch.Tensor], lr: float) -> torch.optim.AdamW:
    """AdamW with torch defaults (betas 0.9/0.999, eps 1e-8, wd 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-2)


@torch.no_grad()
def predict_labels(model: Model, images: torch.Tensor, batch_size: int = 256) -> torch.Tensor:
    """Clean-model predictions for a whole dataset, one pass."""
    return torch.cat([torch.argmax(model(images[s:s + batch_size]).float(), dim=-1)
                      for s in range(0, images.shape[0], batch_size)])


def _adamw_loop(x: torch.Tensor, loss_fn, project, lr: float, steps: int,
                tol: float) -> torch.Tensor:
    """Projected AdamW on ``x`` for at most ``steps`` iterations, stopping
    early once ``max|Δx| < tol``. Returns the final iterate (detached)."""
    x = x.detach().clone().requires_grad_(True)
    opt = make_optimizer([x], lr)
    for _ in range(steps):
        (x.grad,) = torch.autograd.grad(loss_fn(x), x)
        prev = x.detach().clone()
        opt.step()
        with torch.no_grad():
            x.copy_(project(x))
            delta = torch.max(torch.abs(x - prev))
        if delta.item() < tol:
            break
    return x.detach()


def supervised_ddrague(
    model: Model,
    d: torch.Tensor,
    images: torch.Tensor,
    cfg: AdilConfig,
    eps: Optional[float] = None,
    kappa: Optional[float] = None,
) -> torch.Tensor:
    """Optimize an image-shaped z, reading codes off via the pseudo-inverse.

    AdamW(lr=code_lr) on z for at most ``steps_inference`` iterations, z
    clamped to [-eps, eps] after each step, early stop when max|Δz| < tol.
    Only z is eps-clamped: the returned perturbation D D† z is z's
    projection onto span(D), which can exceed eps in l∞. That is the
    reference's behaviour and is kept.
    """
    eps = cfg.eps if eps is None else eps
    kappa = cfg.kappa if kappa is None else kappa
    with torch.no_grad():
        labels = torch.argmax(model(images).float(), dim=-1)
        d_pinv = dict_pinv(d)
    red = "mean" if cfg.loss == "ce" else "sum"

    def loss_fn(z):
        dv = dict_apply(codes_from_pinv(z, d_pinv), d).reshape(images.shape)
        logits = model(images + dv).float()
        return attack_loss(logits, labels, loss=cfg.loss, targeted=cfg.targeted,
                           kappa=kappa, reduction=red)

    z = _adamw_loop(torch.zeros_like(images), loss_fn,
                    lambda z: linf_clamp(z, eps), cfg.code_lr,
                    cfg.steps_inference, cfg.tol)
    with torch.no_grad():
        v = codes_from_pinv(z, d_pinv)
        return fused_perturb(v, d, images, float("inf"))


def supervised_adamw_codes(
    model: Model,
    d: torch.Tensor,
    images: torch.Tensor,
    cfg: AdilConfig,
    return_fooling: bool = False,
    eps: Optional[float] = None,
    kappa: Optional[float] = None,
):
    """Optimize fresh codes v for a batch against a frozen dictionary.

    AdamW(lr=code_lr) with the l1/l2-ball projection after each step, at
    most ``steps_code`` iterations, early stop on max|Δv| < tol.
    ``return_fooling=True`` returns the fooling count of the unclipped
    adversaries instead (the training-time validation path).
    """
    eps = cfg.eps if eps is None else eps
    kappa = cfg.kappa if kappa is None else kappa
    with torch.no_grad():
        labels = torch.argmax(model(images).float(), dim=-1)
    red = "mean" if cfg.loss == "ce" else "sum"

    def loss_fn(v):
        dv = dict_apply(v, d).reshape(images.shape)
        logits = model(images + dv).float()
        return attack_loss(logits, labels, loss=cfg.loss, targeted=cfg.targeted,
                           kappa=kappa, reduction=red)

    v0 = torch.zeros((images.shape[0], cfg.n_atoms), dtype=images.dtype,
                     device=images.device)
    v = _adamw_loop(v0, loss_fn, lambda v: project_codes(v, eps, cfg.norm),
                    cfg.code_lr, cfg.steps_code, cfg.tol)
    with torch.no_grad():
        v = project_codes(v, eps, cfg.norm)
        if return_fooling:
            adv = images + dict_apply(v, d).reshape(images.shape)
            adv_labels = torch.argmax(model(adv).float(), dim=-1)
            return torch.sum(adv_labels != labels)
        return fused_perturb(v, d, images, float("inf"))


def sample_sphere(generator: torch.Generator, n: int, cfg: AdilConfig,
                  eps: Optional[float] = None) -> torch.Tensor:
    """Sample codes on the budget sphere, on the generator's device.

    l2: uniform cube direction scaled to the eps l2-sphere; linf: entries
    ~ U(eps, 2 eps) projected onto the eps l1-ball (landing on its surface).
    """
    eps = cfg.eps if eps is None else eps
    u = torch.rand((n, cfg.n_atoms), generator=generator, device=generator.device)
    if cfg.norm == "l2":
        var = u * 2.0 - 1.0
        nrm = torch.linalg.norm(var, dim=1, keepdim=True)
        return eps * var / torch.clamp(nrm, min=1e-12)
    return project_codes(eps + u * eps, eps, cfg.norm)


@torch.no_grad()
def unsupervised_sample(
    model: Model,
    d: torch.Tensor,
    images: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: AdilConfig,
    eps: Optional[float] = None,
    v_trials: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Best-of-trials random-code attack.

    Per image, across ``trials`` draws: once any draw fools the model, keep
    the minimum-MSE fooling adversary; until then keep the minimum-MSE
    non-fooling one. dv is clamped to ±eps before the pixel clip, inside the
    ``fused_perturb`` kernel. ``v_trials`` ((trials, N, K)) replaces the
    sampler with given codes, and then ``generator`` may be None.
    """
    eps = cfg.eps if eps is None else eps
    pre_labels = torch.argmax(model(images).float(), dim=-1)
    n = images.shape[0]
    if v_trials is None:
        v_trials = [sample_sphere(generator, n, cfg, eps) for _ in range(cfg.trials)]

    fooled = torch.zeros(n, dtype=torch.bool, device=images.device)
    mse_fool = torch.full((n,), float("inf"), device=images.device)
    mse_nofool = torch.full((n,), float("inf"), device=images.device)
    best = images.clone()
    pixel_axes = tuple(range(1, images.dim()))
    for v in v_trials:
        adv = fused_perturb(v.contiguous(), d, images, eps)
        fooling = torch.argmax(model(adv).float(), dim=-1) != pre_labels
        mse = torch.sum((images - adv) ** 2, dim=pixel_axes)

        take_fool = fooling & (mse < mse_fool)
        take_nofool = ~fooled & ~fooling & (mse < mse_nofool)
        mse_fool = torch.where(take_fool, mse, mse_fool)
        mse_nofool = torch.where(take_nofool, mse, mse_nofool)
        take = (take_fool | take_nofool).reshape((n,) + (1,) * (images.dim() - 1))
        best = torch.where(take, adv, best)
        fooled = fooled | fooling
    return best
