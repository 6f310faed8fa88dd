"""Plain unsupervised best-of-trials sampling.

Codes are drawn per trial from a generator on the images' device: u ~
U(0, 1) of shape (N, K), then eps + u * eps projected onto the eps l1 ball.
Each trial's adversary is clip(x + clamp(v D, ±eps), 0, 1). Per image, once
any trial fools the clean label, the fooling adversary of least squared
distance is kept; until then the non-fooling one of least distance.
"""

from __future__ import annotations

import torch

from .plain import l1_ball


def trials(model, d: torch.Tensor, images: torch.Tensor, generator: torch.Generator,
           att: dict, n_trials: int) -> dict:
    """Every trial's adversary, fooling decision and the decision's margin
    (the gap between the clean label's logit and the best other one at the
    adversary), and the index of the trial that best-of-trials keeps."""
    k, n, eps = d.shape[0], images.shape[0], att["eps"]
    d_flat = d.reshape(k, -1)
    with torch.no_grad():
        pre = model(images).argmax(dim=-1)
        codes = [l1_ball(eps + torch.rand((n, k), generator=generator, device=images.device) * eps,
                         eps) for _ in range(n_trials)]
        advs, fools, margins, dists = [], [], [], []
        for v in codes:
            adv = torch.clamp(images + torch.clamp((v @ d_flat).reshape(images.shape), -eps, eps),
                              0.0, 1.0)
            logits = model(adv)
            true = logits.gather(1, pre[:, None])[:, 0]
            other = logits.scatter(1, pre[:, None], float("-inf")).amax(dim=-1)
            advs.append(adv)
            fools.append(logits.argmax(dim=-1) != pre)
            margins.append(true - other)
            dists.append(torch.sum((images - adv) ** 2, dim=tuple(range(1, images.dim()))))
        keep = pick(torch.stack(fools), torch.stack(dists))
    return dict(advs=torch.stack(advs), fools=torch.stack(fools), margins=torch.stack(margins),
                keep=keep)


def pick(fools: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """Best-of-trials from (trials, N) decisions and distances: the index
    of the kept trial of each image."""
    inf = torch.full_like(dists[0], float("inf"))
    best_f, best_n = inf.clone(), inf.clone()
    fooled = torch.zeros_like(fools[0])
    keep = torch.zeros(dists.shape[1], dtype=torch.int64, device=dists.device)
    for t in range(dists.shape[0]):
        take_f = fools[t] & (dists[t] < best_f)
        take_n = ~fooled & ~fools[t] & (dists[t] < best_n)
        best_f = torch.where(take_f, dists[t], best_f)
        best_n = torch.where(take_n, dists[t], best_n)
        keep = torch.where(take_f | take_n, torch.full_like(keep, t), keep)
        fooled = fooled | fools[t]
    return keep
