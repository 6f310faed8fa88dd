"""FGSM-family baselines: RFGSM, FFGSM, MIFGSM, EOTPGD, TPGD, DIFGSM, GN, VANILA.

Port of ``dl_attack_on_imagenet_tpu/attacks/fgsm_family.py``: the same
published algorithms at the torchattacks call signatures, each step one
forward and one backward of the victim on the whole batch. Every random
draw is an argument of the functional core; the classes draw it from their
seeded host generator.

DI²-FGSM's input diversity is JAX's ``scale_and_translate`` with a triangle
kernel and no antialiasing: a bilinear resize to ``rnd`` and a zero pad at
``(pad_top, pad_left)``. Here it is two small interpolation matrices, one
over H and one over W, built from the same formula and applied by
``einsum``, so the values are JAX's and the backward is the exact,
deterministic adjoint.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models import VictimModel
from ..ops import clamp_image, cross_entropy_mean
from .base import Attack, Seeded
from .pgd import ce_grad, linf_start


def _mean_abs_normalize(g: torch.Tensor) -> torch.Tensor:
    """``g / mean(|g|)`` per image, with a 1e-12 floor on the mean."""
    return g / torch.clamp(torch.mean(torch.abs(g), dim=(1, 2, 3), keepdim=True), min=1e-12)


def _project(adv, images, eps):
    return clamp_image(images + torch.clamp(adv - images, -eps, eps))


def vanila(images):
    """Identity 'attack' (torchattacks VANILA): the clean images."""
    return images


def gn(images, sigma, noise):
    """Additive Gaussian noise ``sigma * noise`` (``noise`` a standard
    normal draw of the images' shape), clamped to [0, 1]."""
    return clamp_image(images + sigma * noise.to(images))


def rfgsm(model, images, labels, eps, alpha, steps: int, noise, targeted=False):
    """R+FGSM (Tramèr et al. 2017), multi-step: start at
    ``x + alpha * sign(noise)`` (``noise`` standard normal), then ``steps``
    signed-gradient steps of size ``eps - alpha``, each clamped to the
    eps-ball and to [0, 1]."""
    adv = clamp_image(images + alpha * torch.sign(noise.to(images)))
    for _ in range(steps):
        g = ce_grad(model, adv, labels, targeted)
        adv = _project(adv + (eps - alpha) * torch.sign(g), images, eps)
    return adv


def ffgsm(model, images, labels, eps, alpha, delta0, targeted=False):
    """FFGSM (Wong et al. 2020): the uniform start ``delta0`` in the
    eps-ball, one signed-gradient step of size alpha, then the eps-ball and
    [0, 1] clamps."""
    adv = clamp_image(images + delta0.to(images))
    g = ce_grad(model, adv, labels, targeted)
    return _project(adv + alpha * torch.sign(g), images, eps)


def mifgsm(model, images, labels, eps, alpha, decay, steps: int, targeted=False):
    """MI-FGSM (Dong et al. 2018): each step's gradient is normalized by its
    per-image mean |g|, accumulated as ``m <- g_norm + decay * m``, and
    followed by a signed step of size alpha."""
    adv, mom = images, torch.zeros_like(images)
    for _ in range(steps):
        g = _mean_abs_normalize(ce_grad(model, adv, labels, targeted)) + decay * mom
        adv = _project(adv + alpha * torch.sign(g), images, eps)
        mom = g
    return adv


def tpgd(model, images, eps, alpha, steps: int, noise):
    """TPGD (TRADES, Zhang et al. 2019): PGD ascent on the summed
    KL(p_clean || p_adv), labels unused. The start ``x + 0.001 * noise``
    is not clamped; the first step's projection clamps."""
    with torch.no_grad():
        logit_ori = model(images).float()
    p_ori = torch.softmax(logit_ori, dim=-1)
    logp_ori = torch.log_softmax(logit_ori, dim=-1)
    adv = images + 0.001 * noise.to(images)
    for _ in range(steps):
        x = adv.detach().requires_grad_(True)
        with torch.enable_grad():
            logp_adv = torch.log_softmax(model(x).float(), dim=-1)
            kl = torch.sum(p_ori * (logp_ori - logp_adv))
            g = torch.autograd.grad(kl, x)[0]
        adv = _project(adv + alpha * torch.sign(g), images, eps)
    return adv


def eotpgd(model, images, labels, eps, alpha, steps: int, eot_iter: int,
           random_start=True, targeted=False, delta0=None):
    """EOT-PGD (Athalye et al. 2018): each step sums the CE gradient over
    ``eot_iter`` evaluations before the signed step (the evaluations
    coincide for a deterministic victim)."""
    if random_start:
        adv = clamp_image(images + delta0.to(images))
    else:
        adv = images
    for _ in range(steps):
        g = torch.zeros_like(adv)
        for _ in range(eot_iter):
            g = g + ce_grad(model, adv, labels, targeted)
        adv = _project(adv + alpha * torch.sign(g), images, eps)
    return adv


def interpolation_matrix(size: int, rnd: int, pad: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """The (size, size) matrix ``W[input, output]`` that resizes one axis
    bilinearly from ``size`` to ``rnd`` samples and puts them at offset
    ``pad``, zero elsewhere: JAX's ``compute_weight_mat`` with the triangle
    kernel, no antialiasing, scale ``rnd / size`` and translation ``pad``,
    in its float32 arithmetic."""
    scale = torch.tensor(rnd, dtype=torch.float32) / size
    translation = torch.tensor(float(pad), dtype=torch.float32)
    inv_scale = 1.0 / scale
    grid = torch.arange(size, dtype=torch.float32)
    sample_f = (grid + 0.5) * inv_scale - translation * inv_scale - 0.5
    weights = torch.clamp(1.0 - torch.abs(sample_f[None, :] - grid[:, None]), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= size - 0.5)
    weights = torch.where(inside[None, :], weights, 0.0)
    return weights.to(dtype=dtype, device=device)


def input_diversity(x: torch.Tensor, rnd: int, pad_top: int, pad_left: int,
                    use: bool) -> torch.Tensor:
    """DI²-FGSM's transform of a square NHWC batch: where ``use``, the
    bilinear resize to ``rnd`` zero-padded back to the input size at
    ``(pad_top, pad_left)``; else ``x`` itself."""
    if not use:
        return x
    size = x.shape[1]
    w_h = interpolation_matrix(size, rnd, pad_top, x.dtype, x.device)
    w_w = interpolation_matrix(size, rnd, pad_left, x.dtype, x.device)
    return torch.einsum("nhwc,hp,wq->npqc", x, w_h, w_w)


def diversity_draws(generator: torch.Generator, size: int, resize_low: int,
                    diversity_prob: float, steps: int) -> list:
    """Each step's ``(rnd, pad_top, pad_left, use)``: ``rnd`` uniform in
    [resize_low, size), each pad uniform in [0, size - rnd), and ``use``
    with probability ``diversity_prob``."""
    out = []
    for _ in range(steps):
        rnd = int(torch.randint(resize_low, size, (), generator=generator))
        rem = size - rnd
        pad_top = int(torch.randint(0, rem, (), generator=generator))
        pad_left = int(torch.randint(0, rem, (), generator=generator))
        use = bool(torch.rand((), generator=generator) < diversity_prob)
        out.append((rnd, pad_top, pad_left, use))
    return out


def difgsm(model, images, labels, eps, alpha, decay, steps: int,
           diversity: Sequence[Tuple[int, int, int, bool]], random_start=False,
           targeted=False, delta0=None):
    """DI²-FGSM (Xie et al. 2019): MI-FGSM whose gradient is taken through
    :func:`input_diversity` of the iterate, with step i's
    ``diversity[i] = (rnd, pad_top, pad_left, use)``."""
    if len(diversity) != steps:
        raise ValueError(f"difgsm needs {steps} diversity draws, got {len(diversity)}")
    coeff = -1.0 if targeted else 1.0
    adv = clamp_image(images + delta0.to(images)) if random_start else images
    mom = torch.zeros_like(images)
    for draw in diversity:
        x = adv.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = model(input_diversity(x, *draw)).float()
            g = torch.autograd.grad(coeff * cross_entropy_mean(logits, labels), x)[0]
        g = _mean_abs_normalize(g) + decay * mom
        adv = _project(adv + alpha * torch.sign(g), images, eps)
        mom = g
    return adv


class VANILA(Attack):
    """Identity baseline."""

    def __init__(self, victim: VictimModel):
        super().__init__(victim, "VANILA")

    def forward(self, images, labels):
        return vanila(images)


class GN(Seeded):
    """Gaussian-noise baseline; ``sigma`` (the reference's keyword) or
    ``std`` (torchattacks')."""

    def __init__(self, victim: VictimModel, std: float = 0.1, sigma: float = None,
                 seed: int = 0):
        super().__init__(victim, "GN", False, seed)
        self.std = std if sigma is None else sigma

    def forward(self, images, labels, draws=None):
        self._rng_calls += 1
        if draws is None:
            draws = torch.randn(images.shape, generator=self._generator())
        return gn(images, self.std, draws)


class RFGSM(Seeded):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 2 / 255,
                 steps: int = 10, targeted: bool = False, seed: int = 0):
        super().__init__(victim, "RFGSM", targeted, seed)
        self.eps, self.alpha, self.steps = eps, alpha, steps

    def forward(self, images, labels, draws=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        if draws is None:
            draws = torch.randn(images.shape, generator=self._generator())
        return rfgsm(self.victim, images, labels, self.eps, self.alpha, self.steps, draws,
                     self.targeted)


class FFGSM(Seeded):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 10 / 255,
                 targeted: bool = False, seed: int = 0):
        super().__init__(victim, "FFGSM", targeted, seed)
        self.eps, self.alpha = eps, alpha

    def forward(self, images, labels, draws=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        if draws is None:
            draws = linf_start(self._generator(), images.shape, self.eps)
        return ffgsm(self.victim, images, labels, self.eps, self.alpha, draws, self.targeted)


class MIFGSM(Attack):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 2 / 255,
                 steps: int = 10, decay: float = 1.0, targeted: bool = False):
        super().__init__(victim, "MIFGSM", targeted)
        self.eps, self.alpha, self.steps, self.decay = eps, alpha, steps, decay

    def forward(self, images, labels):
        labels = self.get_target(images, labels)
        return mifgsm(self.victim, images, labels, self.eps, self.alpha, self.decay,
                      self.steps, self.targeted)


class TPGD(Seeded):
    """TRADES PGD, untargeted only (the objective has no label term)."""

    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 2 / 255,
                 steps: int = 10, seed: int = 0):
        super().__init__(victim, "TPGD", False, seed)
        self.eps, self.alpha, self.steps = eps, alpha, steps

    def forward(self, images, labels, draws=None):
        self._rng_calls += 1
        if draws is None:
            draws = torch.randn(images.shape, generator=self._generator())
        return tpgd(self.victim, images, self.eps, self.alpha, self.steps, draws)


class EOTPGD(Seeded):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 2 / 255,
                 steps: int = 10, eot_iter: int = 2, random_start: bool = True,
                 targeted: bool = False, seed: int = 0):
        super().__init__(victim, "EOTPGD", targeted, seed)
        self.eps, self.alpha, self.steps = eps, alpha, steps
        self.eot_iter = eot_iter
        self.random_start = random_start

    def forward(self, images, labels, draws=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        if draws is None and self.random_start:
            draws = linf_start(self._generator(), images.shape, self.eps)
        return eotpgd(self.victim, images, labels, self.eps, self.alpha, self.steps,
                      self.eot_iter, self.random_start, self.targeted, draws)


class DIFGSM(Seeded):
    def __init__(self, victim: VictimModel, eps: float = 8 / 255, alpha: float = 2 / 255,
                 steps: int = 10, decay: float = 0.0, resize_rate: float = 0.9,
                 diversity_prob: float = 0.5, random_start: bool = False,
                 targeted: bool = False, seed: int = 0):
        super().__init__(victim, "DIFGSM", targeted, seed)
        self.eps, self.alpha, self.steps, self.decay = eps, alpha, steps, decay
        self.resize_rate, self.diversity_prob = resize_rate, diversity_prob
        self.random_start = random_start

    def draws(self, shape) -> Tuple[Optional[torch.Tensor], list]:
        """This call's (random start or None, per-step diversity draws)."""
        size = shape[1]
        resize_low = int(size * self.resize_rate)
        if not 1 <= resize_low < size:
            raise ValueError(f"resize_rate={self.resize_rate} leaves no valid sizes")
        g = self._generator()
        delta0 = linf_start(g, shape, self.eps) if self.random_start else None
        return delta0, diversity_draws(g, size, resize_low, self.diversity_prob, self.steps)

    def forward(self, images, labels, draws=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        delta0, diversity = self.draws(images.shape) if draws is None else draws
        return difgsm(self.victim, images, labels, self.eps, self.alpha, self.decay,
                      self.steps, diversity, self.random_start, self.targeted, delta0)
