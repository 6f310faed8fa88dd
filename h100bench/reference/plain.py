"""The attack's arithmetic in plain torch: the CW margin, the codes'
projection, an AdamW step, the pseudo-inverse of a dictionary."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-2


def cw_margin(logits: torch.Tensor, labels: torch.Tensor, kappa: float) -> torch.Tensor:
    """Untargeted CW margin per row: ``max(logit[y] - runner_up, -kappa)``,
    with the runner-up the largest of ``logits * (1 - one_hot(y))`` (so a
    row whose other logits are all negative has the runner-up 0)."""
    others = logits * (1.0 - F.one_hot(labels, logits.shape[-1]).to(logits.dtype))
    true = logits.gather(1, labels[:, None])[:, 0]
    return torch.clamp(true - torch.amax(others, dim=-1), min=-kappa)


def l1_ball(x: torch.Tensor, radius: float) -> torch.Tensor:
    """Euclidean projection of each row onto the l1 ball of ``radius``
    (Duchi et al. 2008: sort, then the threshold); rows inside stay."""
    a = x.abs()
    s = torch.sort(a, dim=1, descending=True).values
    css = torch.cumsum(s, dim=1)
    j = torch.arange(1, x.shape[1] + 1, device=x.device, dtype=x.dtype)
    rho = torch.sum((s * j > css - radius).to(torch.int64), dim=1)  # >= 1
    theta = (css.gather(1, (rho - 1)[:, None])[:, 0] - radius) / rho.to(x.dtype)
    proj = torch.sign(x) * torch.clamp(a - theta[:, None], min=0.0)
    return torch.where((a.sum(dim=1) < radius)[:, None], x, proj)


def adamw(p, g, mu, nu, step: int, lr: float, clip: float = float("inf")):
    """One AdamW step (torch's defaults: betas 0.9/0.999, eps 1e-8, weight
    decay 1e-2, decoupled), then the clamp to ±clip. Returns new tensors."""
    b1, b2 = BETAS
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mu_hat = mu / (1 - b1 ** step)
    nu_hat = nu / (1 - b2 ** step)
    p = p - lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) + WEIGHT_DECAY * p)
    return torch.clamp(p, -clip, clip), mu, nu


def pinv_rows(d_flat: torch.Tensor) -> torch.Tensor:
    """D† = (D Dᵀ)⁻¹ D for a (K, M) dictionary of full row rank."""
    return torch.linalg.solve(d_flat @ d_flat.T, d_flat)


def labels_of(model, images: torch.Tensor, chunk: int = 100) -> torch.Tensor:
    """The clean model's top-1 class of every image."""
    with torch.no_grad():
        return torch.cat([model(images[i:i + chunk]).argmax(dim=-1)
                          for i in range(0, images.shape[0], chunk)])
