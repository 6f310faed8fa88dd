"""Projection operators for constrained attack optimization.

Port of ``dl_attack_on_imagenet_tpu/ops/projections.py``: the same batched
formulations (sort-based Duchi l1 projection, ``min(1, r/||x||)`` l2 scaling)
on torch tensors.
"""

from __future__ import annotations

import torch


def clamp_image(image: torch.Tensor, min_val: float = 0.0, max_val: float = 1.0) -> torch.Tensor:
    """Clip an image to the valid pixel range."""
    return torch.clamp(image, min_val, max_val)


def linf_clamp(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Project onto the l∞ ball of radius ``eps`` (elementwise clamp)."""
    return torch.clamp(x, -eps, eps)


def l1_ball_project(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Euclidean projection of each row of ``x`` onto the l1 ball of radius eps.

    Duchi et al. (ICML 2008) sort-based algorithm over the last axis, batched
    over the leading ones. Rows already inside the ball are returned
    unchanged.
    """
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    d = x2.shape[1]

    abs_x = x2.abs()
    inside = (abs_x.sum(dim=1, keepdim=True) < eps).to(x2.dtype)

    # mu: row-wise descending sort of |x|; theta from the KKT conditions.
    mu = torch.sort(abs_x, dim=1, descending=True).values
    cumsum = torch.cumsum(mu, dim=1)
    arange = torch.arange(1, d + 1, dtype=x2.dtype, device=x2.device)
    # rho = largest index j with mu_j * j > cumsum_j - eps
    cond = (mu * arange > (cumsum - eps)).to(x2.dtype) * arange
    rho = cond.max(dim=1).values
    rho_idx = torch.clamp(rho.to(torch.int64) - 1, min=0)
    theta = (cumsum.gather(1, rho_idx[:, None])[:, 0] - eps) / torch.clamp(rho, min=1.0)
    proj = torch.clamp(abs_x - theta[:, None], min=0.0) * torch.sign(x2)

    out = inside * x2 + (1.0 - inside) * proj
    return out.reshape(orig_shape)


def l2_ball_project(x: torch.Tensor, radius: float = 1.0, axis=None) -> torch.Tensor:
    """Project onto the l2 ball of the given radius.

    With ``axis`` None the whole tensor is one vector; otherwise the norm is
    taken over ``axis`` (int or tuple). ``min(1, r/||x||)`` keeps
    ``radius=inf`` a no-op where ``r/max(||x||, r)`` would give inf/inf.
    """
    if axis is None:
        sq = torch.sum(x * x)
    else:
        sq = torch.sum(x * x, dim=axis, keepdim=True)
    norm = torch.sqrt(torch.clamp(sq, min=1e-24))
    scale = torch.clamp(radius / norm, max=1.0)
    return x * scale


def project_codes(v: torch.Tensor, eps: float, norm: str = "linf") -> torch.Tensor:
    """Projection of coding vectors ``v`` (N, K) enforcing the attack budget.

    l∞ budget: each code row onto the l1 ball of radius eps (so that
    ``||D v||_inf <= eps`` when ``||D||_inf <= 1``); l2 budget: the l2 ball.
    """
    norm = norm.lower()
    if norm == "l2":
        return l2_ball_project(v, eps, axis=1)
    if norm == "linf":
        return l1_ball_project(v, eps)
    raise ValueError(f"unknown norm: {norm}")


def project_dictionary(d: torch.Tensor, norm: str = "linf") -> torch.Tensor:
    """Projection of the dictionary under the attack-budget norm.

    l∞ budget: atoms clamped to [-1, 1] elementwise; l2 budget: each atom
    (row of the flattened dictionary) onto the unit l2 ball.
    """
    norm = norm.lower()
    if norm == "l2":
        flat = d.reshape(d.shape[0], -1)
        return l2_ball_project(flat, 1.0, axis=1).reshape(d.shape)
    if norm == "linf":
        return torch.clamp(d, -1.0, 1.0)
    raise ValueError(f"unknown norm: {norm}")
