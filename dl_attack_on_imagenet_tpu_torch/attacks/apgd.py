"""Auto-PGD (APGD) and its targeted variant APGD-T.

Port of ``dl_attack_on_imagenet_tpu/attacks/apgd.py`` (Croce & Hein, ICML
2020): the start on the eps-ball's surface, the momentum step (0.75 from the
second step), the per-image step halving at the paper's checkpoints when
fewer than rho = 0.75 of the interval's updates improved the objective
(cond1) or neither the step nor the best objective moved since the last
checkpoint (cond2), and the restart from the best point with the momentum
reset. The objective, per-image CE, DLR or targeted DLR, is maximized.

Each step is one forward and one backward of the whole batch in float32.
The checkpoint schedule is computed on the host, as the JAX package
computes it while tracing, so a step that is no checkpoint does no
checkpoint work. The start's draw ``u`` is an argument; the classes draw it
from their seeded host generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import VictimModel
from ..ops import dlr_loss, dlr_loss_targeted
from .base import Seeded

RHO = 0.75
ALPHA_MOMENTUM = 0.75


def _schedule(n_iter: int):
    """(checkpoint mask, interval length) of each iteration, on the host."""
    p = [0.0, 0.22]
    while p[-1] < 1.0:
        p.append(p[-1] + max(p[-1] - p[-2] - 0.03, 0.06))
    ckpts = sorted({min(int(math.ceil(pj * n_iter)), n_iter) for pj in p[1:]})
    is_ck = np.zeros(n_iter, bool)
    interval = np.zeros(n_iter, np.float32)
    prev = 0
    for w in ckpts:
        if 1 <= w <= n_iter:
            is_ck[w - 1] = True
            interval[w - 1] = w - prev
            prev = w
    return is_ck, interval


def _per_image_loss(logits, labels, targets, loss: str):
    logits = logits.float()
    if loss == "ce":
        return -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    if loss == "dlr":
        return dlr_loss(logits, labels)
    if loss == "dlr-targeted":
        return dlr_loss_targeted(logits, labels, targets)
    raise ValueError(f"unknown APGD loss: {loss}")


def start_draw(generator: torch.Generator, shape, norm: str) -> torch.Tensor:
    """The start's draw on the host: U(-1, 1) for l∞, N(0, 1) for l2."""
    if norm == "linf":
        return 2.0 * torch.rand(shape, generator=generator) - 1.0
    return torch.randn(shape, generator=generator)


def _bcast(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None, None, None]


def apgd(model, images, labels, eps, steps: int, norm: str = "linf", loss: str = "ce",
         targets=None, eot_iter: int = 1, u: Optional[torch.Tensor] = None,
         stats: Optional[dict] = None):
    """One APGD run; ``targets`` are required for 'dlr-targeted', ``u`` is
    the start's draw (:func:`start_draw`).

    Returns (adv, succ): each image's last fooling iterate, or its
    highest-objective one where none fooled, and whether any fooled. With
    ``stats``, ``stats["steps"]`` gets each image's step size after each
    checkpoint (host arrays).
    """
    if u is None:
        raise ValueError("apgd needs its start draw u")
    x = images.float()
    n = x.shape[0]
    is_ck, interval = _schedule(steps)
    targeted = loss == "dlr-targeted"
    if targets is None:
        targets = labels  # unused by the untargeted losses

    def l2_norm(t):
        return torch.sqrt(torch.sum(t * t, dim=(1, 2, 3), keepdim=True))

    def ball_box(v):
        if norm == "linf":
            v = x + torch.clamp(v - x, -eps, eps)
        else:
            d = v - x
            v = x + d * torch.clamp(eps / torch.clamp(l2_norm(d), min=1e-12), max=1.0)
        return torch.clamp(v, 0.0, 1.0)

    def once(v):
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = model(v)
            per = _per_image_loss(logits, labels, targets, loss)
            g = torch.autograd.grad(per.sum(), v)[0]
        return per.detach(), torch.argmax(logits.detach(), dim=-1), g

    def val_grad(v):
        if eot_iter == 1:
            return once(v)
        g_acc = torch.zeros_like(v)
        for _ in range(eot_iter):
            per, pred, g = once(v)
            g_acc = g_acc + g
        return per, pred, g_acc / eot_iter

    def fooled_by(pred):
        return (pred == targets) if targeted else (pred != labels)

    # The draw keeps its dtype: a float64 one promotes the iterates to
    # float64, as JAX promotes them under x64 (the losses stay float32).
    u = u.to(x.device)
    if norm == "linf":
        mx = torch.amax(torch.abs(u), dim=(1, 2, 3), keepdim=True)
        x0 = x + eps * u / torch.clamp(mx, min=1e-12)
    else:
        x0 = x + eps * u / torch.clamp(l2_norm(u), min=1e-12)
    x0 = torch.clamp(x0, 0.0, 1.0)

    f_adv, pred0, g = val_grad(x0)
    succ = fooled_by(pred0)
    step = torch.full((n,), 2.0, dtype=x0.dtype, device=x.device) * eps
    x_adv = x_old = x_best = x_bad = x0
    f_best, g_best = f_adv, g
    cnt = torch.zeros((n,), device=x.device)
    ck_step, ck_fbest = step, f_adv
    for i in range(steps):
        a = 1.0 if i == 0 else ALPHA_MOMENTUM
        s4 = step[:, None, None, None]
        if norm == "linf":
            z = x_adv + s4 * torch.sign(g)
        else:
            z = x_adv + s4 * g / torch.clamp(l2_norm(g), min=1e-12)
        z = ball_box(z)
        x_new = ball_box(x_adv + a * (z - x_adv) + (1.0 - a) * (x_adv - x_old))

        f_new, pred, g_new = val_grad(x_new)
        cnt = cnt + (f_new > f_adv).float()
        better = f_new > f_best
        x_best = torch.where(_bcast(better), x_new, x_best)
        g_best = torch.where(_bcast(better), g_new, g_best)
        f_best = torch.where(better, f_new, f_best)
        fooled = fooled_by(pred)
        x_bad = torch.where(_bcast(fooled), x_new, x_bad)
        succ = succ | fooled

        x_old, x_adv, g, f_adv = x_adv, x_new, g_new, f_new
        if is_ck[i]:
            cond1 = cnt < RHO * float(interval[i])
            cond2 = (step == ck_step) & (f_best == ck_fbest)
            halve = cond1 | cond2
            step = torch.where(halve, step * 0.5, step)
            h4 = _bcast(halve)
            x_adv = torch.where(h4, x_best, x_new)
            g = torch.where(h4, g_best, g_new)
            f_adv = torch.where(halve, f_best, f_new)
            x_old = torch.where(h4, x_best, x_old)  # momentum reset on restart
            ck_step, ck_fbest = step, f_best
            cnt = torch.zeros_like(cnt)
            if stats is not None:
                stats.setdefault("steps", []).append(step.cpu().numpy())
    adv = torch.where(_bcast(succ), x_bad, x_best)
    return adv.to(images.dtype), succ


def _merge(out, succ, adv, s):
    """Keep each image's first fooling run: where ``out`` has not fooled
    and ``adv`` has, take ``adv``."""
    if out is None:
        return adv, s
    take = ~succ & s
    return torch.where(_bcast(take), adv, out), succ | s


class APGD(Seeded):
    """Untargeted APGD (loss 'ce' or 'dlr'), ``n_restarts`` merged per image:
    the first restart to fool an image wins; an image never fooled keeps the
    first run's highest-objective iterate."""

    def __init__(self, victim: VictimModel, norm: str = "Linf", eps: float = 8 / 255,
                 steps: int = 10, n_restarts: int = 1, seed: int = 0, loss: str = "ce",
                 eot_iter: int = 1, rho: float = RHO):
        super().__init__(victim, "APGD", False, seed)
        if rho != RHO:
            raise ValueError("rho is fixed at the paper's 0.75")
        self.norm = norm.lower()
        if self.norm not in ("linf", "l2"):
            raise ValueError(f"unsupported norm: {norm}")
        self.eps, self.steps, self.n_restarts = eps, steps, n_restarts
        self.loss, self.eot_iter = loss, eot_iter

    def draws(self, shape) -> list:
        """This call's start draw of each restart."""
        return [start_draw(self._generator(r), shape, self.norm)
                for r in range(self.n_restarts)]

    def forward(self, images, labels, draws: Optional[Sequence] = None, stats=None):
        self._rng_calls += 1
        if draws is None:
            draws = self.draws(images.shape)
        out = succ = None
        for u in draws:
            adv, s = apgd(self.victim, images, labels, self.eps, self.steps, norm=self.norm,
                          loss=self.loss, targets=labels, eot_iter=self.eot_iter, u=u,
                          stats=stats)
            out, succ = _merge(out, succ, adv, s)
        return out


class APGDT(Seeded):
    """APGD-Targeted: one targeted-DLR run per candidate class (the 2nd to
    the n_classes-th most probable clean classes, ranked by a stable sort),
    each image keeping its first success."""

    def __init__(self, victim: VictimModel, norm: str = "Linf", eps: float = 8 / 255,
                 steps: int = 10, n_restarts: int = 1, seed: int = 0, eot_iter: int = 1,
                 n_classes: int = 10):
        super().__init__(victim, "APGDT", True, seed)
        self.norm = norm.lower()
        self.eps, self.steps, self.n_restarts = eps, steps, n_restarts
        self.eot_iter, self.n_classes = eot_iter, n_classes

    def ranks(self, num_classes: int) -> range:
        return range(2, 2 + min(self.n_classes - 1, num_classes - 1))

    def draws(self, shape, num_classes: int) -> list:
        """This call's start draws, in run order (rank, then restart)."""
        return [start_draw(self._generator(rank * 131 + r), shape, self.norm)
                for rank in self.ranks(num_classes) for r in range(self.n_restarts)]

    def forward(self, images, labels, draws: Optional[Sequence] = None, stats=None):
        self._rng_calls += 1
        with torch.no_grad():
            order = torch.argsort(self.victim(images), dim=-1, stable=True)  # ascending
        if draws is None:
            draws = self.draws(images.shape, order.shape[-1])
        draws = iter(draws)
        out = succ = None
        for rank in self.ranks(order.shape[-1]):
            targets = order[:, -rank]
            for _ in range(self.n_restarts):
                adv, s = apgd(self.victim, images, labels, self.eps, self.steps,
                              norm=self.norm, loss="dlr-targeted", targets=targets,
                              eot_iter=self.eot_iter, u=next(draws), stats=stats)
                out, succ = _merge(out, succ, adv, s)
        return out
