"""OnePixel attack: black-box differential evolution over a few pixels.

Port of ``dl_attack_on_imagenet_tpu/attacks/one_pixel.py`` (Su et al.
2019, at torchattacks' operating point: scipy's ``best1bin`` with
``recombination=1``, ``mutation=(0.5, 1)``, bounds ``[(0, H), (0, W)] +
[(0, 1)] * C`` per pixel, and a per-image stop once the best member fools).
Every image evolves its population in lockstep with the others under a
freeze mask; candidates are painted and evaluated ``inf_batch`` at a time,
so no more than ``inf_batch`` adversarial images are live. As in the JAX
package, the population is updated once a generation and an out-of-bounds
mutant entry is drawn anew inside its bounds.

Every draw is an argument of :func:`one_pixel_de` (:func:`evolution_draws`
makes them on the host): the first population, and each generation's
dithering F, the members r1 and r2, the redraws, the crossover uniforms and
the forced dimension.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import VictimModel
from .base import Seeded


def _apply_candidate(images: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Paint candidate j (``cands[j]`` of shape (pixels, 2 + C): row and
    column, truncated toward zero, then the channel values) onto
    ``images[j]``, pixel after pixel, so a later pixel wins a duplicate
    coordinate (torchattacks' ``_perturb``). Each pixel is one write of
    distinct batch rows, whose order on the card is then irrelevant."""
    n, h, w, _ = images.shape
    out = images.clone()
    batch = torch.arange(n, device=images.device)
    for p in range(cands.shape[1]):
        row = torch.clamp(cands[:, p, 0].to(torch.int32), 0, h - 1).long()
        col = torch.clamp(cands[:, p, 1].to(torch.int32), 0, w - 1).long()
        out[batch, row, col, :] = cands[:, p, 2:].to(out.dtype)
    return out


def evolution_draws(generator: torch.Generator, n: int, pop: int, dims: int,
                    steps: int) -> dict:
    """The draws of one evolution on the host: ``pop0`` (N, pop, dims)
    uniform; per generation ``f`` (steps,) uniform in [0.5, 1), ``a``
    uniform in [0, pop - 1) and ``b`` in [0, pop - 2) (steps, N, pop),
    ``redraw`` and ``cross`` (steps, N, pop, dims) uniform, and ``forced``
    uniform in [0, dims) (steps, N, pop)."""
    shape = (steps, n, pop)
    return dict(
        pop0=torch.rand((n, pop, dims), generator=generator),
        f=0.5 + 0.5 * torch.rand((steps,), generator=generator),
        a=torch.randint(0, pop - 1, shape, generator=generator),
        b=torch.randint(0, pop - 2, shape, generator=generator),
        redraw=torch.rand(shape + (dims,), generator=generator),
        cross=torch.rand(shape + (dims,), generator=generator),
        forced=torch.randint(0, dims, shape, generator=generator))


def one_pixel_de(model, images, labels, *, steps: int, pixels: int, pop: int,
                 inf_batch: int, targeted: bool, draws: dict, recombination: float = 1.0,
                 stats: Optional[dict] = None):
    """Differential evolution with the draws of :func:`evolution_draws`.

    A candidate's energy is the softmax probability of ``labels``
    (untargeted, minimized) or ``1 - p_target`` (targeted); the evolution
    stops once every image's best member fools. Returns (adv, best energy,
    best fooled). With ``stats``, ``stats["generations"]`` gets the
    generations run and ``stats["accepts"]`` each image's accepted trials
    (a host array).
    """
    x = images.float()
    n, h, w, c = x.shape
    dev = x.device
    dims = pixels * (2 + c)
    lo = torch.zeros(dims, device=dev)
    hi = torch.tensor([float(h), float(w)] + [1.0] * c, device=dev).repeat(pixels)
    draws = {key: val.to(dev) for key, val in draws.items()}
    src = torch.arange(n * pop, device=dev) // pop

    def span(u):
        return lo + (hi - lo) * u

    def energies(pop_all):
        cands = pop_all.reshape(n * pop, pixels, 2 + c)
        probs, preds = [], []
        with torch.no_grad():
            for start in range(0, n * pop, inf_batch):
                chunk = slice(start, start + inf_batch)
                logits = model(_apply_candidate(x[src[chunk]], cands[chunk])).float()
                probs.append(torch.softmax(logits, dim=-1))
                preds.append(torch.argmax(logits, dim=-1))
        probs = torch.cat(probs).reshape(n, pop, -1)
        preds = torch.cat(preds).reshape(n, pop)
        p_lab = probs.gather(2, labels[:, None, None].expand(n, pop, 1))[..., 0]
        if targeted:
            return 1.0 - p_lab, preds == labels[:, None]
        return p_lab, preds != labels[:, None]

    def best_state(pop_all, e, s):
        bidx = torch.argmin(e, dim=1)
        rows = torch.arange(n, device=dev)
        return pop_all[rows, bidx], s[rows, bidx]

    pop_all = span(draws["pop0"])
    e, s = energies(pop_all)
    members = torch.arange(pop, device=dev)[None, :]
    accepts = torch.zeros(n, dtype=torch.int64, device=dev)
    step = 0
    while step < steps:
        best, bfool = best_state(pop_all, e, s)
        if bool(bfool.all()):
            break
        a, b = draws["a"][step], draws["b"][step]
        # r1, r2: distinct members, both other than j.
        r1 = a + (a >= members)
        lo_j, hi_j = torch.minimum(members, r1), torch.maximum(members, r1)
        r2 = b + (b >= lo_j)
        r2 = r2 + (r2 >= hi_j)

        def take(idx):
            return pop_all.gather(1, idx[..., None].expand(n, pop, dims))

        mutant = best[:, None, :] + draws["f"][step] * (take(r1) - take(r2))
        viol = (mutant < lo) | (mutant > hi)
        mutant = torch.where(viol, span(draws["redraw"][step]), mutant)
        # Binomial crossover with one forced dimension per member.
        cross = draws["cross"][step] < recombination
        forced = torch.nn.functional.one_hot(draws["forced"][step].long(), dims) > 0
        trial = torch.where(cross | forced, mutant, pop_all)

        e_t, s_t = energies(trial)
        accept = (e_t < e) & ~bfool[:, None]
        pop_all = torch.where(accept[..., None], trial, pop_all)
        e = torch.where(accept, e_t, e)
        s = torch.where(accept, s_t, s)
        accepts += accept.sum(1)
        step += 1
    if stats is not None:
        stats["generations"] = step
        stats["accepts"] = accepts.cpu().numpy()
    bcand, bfool = best_state(pop_all, e, s)
    adv = _apply_candidate(x, bcand.reshape(n, pixels, 2 + c))
    return adv.to(images.dtype), torch.amin(e, dim=1), bfool


class OnePixel(Seeded):
    """torchattacks' ``OnePixel(model, pixels, steps, popsize, inf_batch)``.
    Each call draws anew (the per-instance call counter), as torchattacks
    consumes the ambient RNG stream."""

    def __init__(self, victim: VictimModel, pixels: int = 1, steps: int = 10,
                 popsize: int = 10, inf_batch: int = 128, seed: int = 0,
                 targeted: bool = False, recombination: float = 1.0):
        super().__init__(victim, "OnePixel", targeted, seed)
        self.pixels, self.steps, self.popsize = pixels, steps, popsize
        self.inf_batch = inf_batch
        self.recombination = recombination

    def population(self, n_channels: int) -> int:
        """torchattacks' scipy multiplier: pop = max(1, popsize // dims) * dims."""
        dims = self.pixels * (2 + n_channels)
        popmul = max(1, self.popsize // dims)
        return max(popmul * dims, 5)  # best1bin needs j, r1, r2 and the best

    def draws(self, shape) -> dict:
        n, c = shape[0], shape[-1]
        return evolution_draws(self._generator(), n, self.population(c),
                               self.pixels * (2 + c), self.steps)

    def forward(self, images, labels, draws=None, stats=None):
        labels = self.get_target(images, labels)
        self._rng_calls += 1
        if draws is None:
            draws = self.draws(images.shape)
        adv, _, _ = one_pixel_de(self.victim, images, labels, steps=self.steps,
                                 pixels=self.pixels, pop=self.population(images.shape[-1]),
                                 inf_batch=self.inf_batch, targeted=self.targeted, draws=draws,
                                 recombination=self.recombination, stats=stats)
        return adv
