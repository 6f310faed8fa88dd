"""Square Attack (l∞): gradient-free random search with square patches.

Port of ``dl_attack_on_imagenet_tpu/attacks/square.py`` (Andriushchenko et
al., ECCV 2020): vertical ±eps stripes to start, then one query a step, each
painting one square of fresh ±eps values per channel at a uniform place in
every image, accepted only on a strict improvement of the objective (the
margin, or -CE). The side follows the released p-schedule. The whole batch
queries in lockstep under an active mask; the loop leaves once no margin is
positive, one host read a query.

Every draw is an argument of :func:`square_linf`: the stripes' signs and
each query's corner and signs. :func:`query_draws` makes them on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import VictimModel
from ..ops.losses import true_and_runner_up
from .base import Seeded


def _p_schedule(p_init: float, n_queries: int) -> np.ndarray:
    """The released piecewise schedule, per query index."""
    frac = (np.arange(n_queries, dtype=np.float64) / max(n_queries, 1)) * 10000
    halvings = np.zeros(n_queries, np.int32)
    for k, lo in enumerate((10, 50, 200, 500, 1000, 2000, 4000, 6000, 8000)):
        halvings = np.where(frac > lo, k + 1, halvings)
    return p_init / (2.0 ** halvings)


def _sizes(p_init: float, n_queries: int, h: int, w: int) -> np.ndarray:
    p = _p_schedule(p_init, n_queries)
    s = np.round(np.sqrt(p * h * w)).astype(np.int32)
    return np.clip(s, 1, h - 1)


def query_draws(generator: torch.Generator, shape, n_queries: int,
                p_init: float = 0.8) -> dict:
    """The draws of one run on the host: ``stripes`` (N, 1, W, C) and
    ``signs`` (Q, N, C) of ±1, and each query's square corner ``h0`` and
    ``w0`` (Q, N), uniform over the places a square of that query's side
    fits."""
    n, h, w, c = shape
    s = torch.as_tensor(_sizes(p_init, n_queries, h, w), dtype=torch.float64)
    sign = lambda size: torch.randint(0, 2, size, generator=generator).float() * 2 - 1  # noqa: E731
    return dict(
        stripes=sign((n, 1, w, c)),
        h0=(torch.rand((n_queries, n), generator=generator, dtype=torch.float64)
            * (h - s + 1)[:, None]).long(),
        w0=(torch.rand((n_queries, n), generator=generator, dtype=torch.float64)
            * (w - s + 1)[:, None]).long(),
        signs=sign((n_queries, n, c)))


def square_linf(model, images, labels, eps, n_queries: int, draws: dict,
                loss: str = "margin", p_init: float = 0.8, targeted=False,
                stats: Optional[dict] = None):
    """Square-l∞ with the draws of :func:`query_draws`.

    Returns (adv, margin): fooled where the margin is negative. With
    ``stats``, ``stats["queries"]`` gets the queries made and
    ``stats["accepts"]`` each image's accepted queries (a host array).
    """
    x = images.float()
    n, h, w, c = x.shape
    dev = x.device
    sizes = _sizes(p_init, n_queries, h, w)

    def objective(u):
        with torch.no_grad():
            logits = model(u).float()
        true_logit, other = true_and_runner_up(logits, labels)
        margin = (other - true_logit) if targeted else (true_logit - other)
        if loss == "margin":
            return margin, margin
        if loss == "ce":
            ce = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
            return (ce if targeted else -ce), margin
        raise ValueError(f"unknown Square loss: {loss}")

    x_best = torch.clamp(x + eps * draws["stripes"].to(x), 0.0, 1.0)
    obj_min, margin_min = objective(x_best)
    h0_all, w0_all = draws["h0"].to(dev), draws["w0"].to(dev)
    signs_all = draws["signs"].to(x)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    accepts = torch.zeros(n, dtype=torch.int64, device=dev)
    i = 0
    while i < n_queries and bool((margin_min > 0).any()):
        s = int(sizes[i])
        h0, w0 = h0_all[i], w0_all[i]
        rho = eps * signs_all[i][:, None, None, :]
        in_h = (rows[None, :] >= h0[:, None]) & (rows[None, :] < h0[:, None] + s)
        in_w = (cols[None, :] >= w0[:, None]) & (cols[None, :] < w0[:, None] + s)
        window = (in_h[:, :, None] & in_w[:, None, :])[..., None]
        cand_delta = torch.where(window, rho, x_best - x)
        cand = torch.clamp(x + torch.clamp(cand_delta, -eps, eps), 0.0, 1.0)
        obj_c, margin_c = objective(cand)
        improved = (margin_min > 0) & (obj_c < obj_min)
        x_best = torch.where(improved[:, None, None, None], cand, x_best)
        obj_min = torch.where(improved, obj_c, obj_min)
        margin_min = torch.where(improved, margin_c, margin_min)
        accepts += improved
        i += 1
    if stats is not None:
        stats["queries"] = i
        stats["accepts"] = accepts.cpu().numpy()
    return x_best.to(images.dtype), margin_min


class Square(Seeded):
    def __init__(self, victim: VictimModel, norm: str = "Linf", eps: float = 8 / 255,
                 n_queries: int = 5000, n_restarts: int = 1, p_init: float = 0.8,
                 loss: str = "ce", seed: int = 0, targeted: bool = False):
        super().__init__(victim, "Square", targeted, seed)
        if norm.lower() != "linf":
            raise ValueError("Square: only norm='Linf' is implemented")
        self.eps, self.n_queries, self.n_restarts = eps, n_queries, n_restarts
        self.loss, self.p_init = loss, p_init

    def draws(self, shape) -> list:
        """This call's draws of each restart."""
        return [query_draws(self._generator(r), shape, self.n_queries, self.p_init)
                for r in range(self.n_restarts)]

    def forward(self, images, labels, draws=None, stats=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        if draws is None:
            draws = self.draws(images.shape)
        out = best_margin = None
        for run in draws:
            adv, margin = square_linf(self.victim, images, labels, self.eps, self.n_queries,
                                      run, loss=self.loss, p_init=self.p_init,
                                      targeted=self.targeted, stats=stats)
            if out is None:
                out, best_margin = adv, margin
            else:
                take = margin < best_margin
                out = torch.where(take[:, None, None, None], adv, out)
                best_margin = torch.where(take, margin, best_margin)
        return out
