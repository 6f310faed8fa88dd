"""Projection and proximal operators for constrained attack optimization.

Port of ``dl_attack_on_imagenet_tpu/ops/projections.py``: the same batched
formulations (sort-based Duchi l1 projection, the bisection l1 projection for
long rows, ``min(1, r/||x||)`` l2 scaling, the soft threshold and the
per-atom dictionary constraints) on torch tensors.
"""

from __future__ import annotations

import torch


def clamp_image(image: torch.Tensor, min_val: float = 0.0, max_val: float = 1.0) -> torch.Tensor:
    """Clip an image to the valid pixel range."""
    return torch.clamp(image, min_val, max_val)


def linf_clamp(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Project onto the l∞ ball of radius ``eps`` (elementwise clamp)."""
    return torch.clamp(x, -eps, eps)


def soft_threshold(x: torch.Tensor, lam) -> torch.Tensor:
    """Soft-thresholding, the prox of ``lam * ||.||_1``. ``lam`` may be a
    tensor (the solvers pass their step tensor times lambda), which
    ``F.softshrink`` does not take."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


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


def l1_ball_project_bisect(x: torch.Tensor, eps: float, iters: int = 50) -> torch.Tensor:
    """l1-ball projection of each row by bisection on the threshold theta.

    The projection is ``sign(x) * relu(|x| - theta)`` where theta >= 0
    solves ``sum(relu(|x| - theta)) = eps``; ``iters`` halvings of
    [0, max|x|] find it. The JAX package's form for long rows, kept exact to
    it (not to the sort-based :func:`l1_ball_project`, which it matches to
    about 1e-6). Same row convention as :func:`l1_ball_project`.
    """
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    abs_x = x2.abs()
    inside = abs_x.sum(dim=1) < eps
    lo = torch.zeros_like(abs_x[:, 0])
    hi = abs_x.max(dim=1).values
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = torch.clamp(abs_x - mid[:, None], min=0.0).sum(dim=1) > eps
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    theta = 0.5 * (lo + hi)
    proj = torch.clamp(abs_x - theta[:, None], min=0.0) * torch.sign(x2)
    return torch.where(inside[:, None], x2, proj).reshape(orig_shape)


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


def l2_sphere_project(x: torch.Tensor, radius: float = 1.0, axis=None) -> torch.Tensor:
    """Project onto the l2 sphere: scale to norm exactly ``radius``."""
    if axis is None:
        sq = torch.sum(x * x)
    else:
        sq = torch.sum(x * x, dim=axis, keepdim=True)
    return x * (radius / torch.sqrt(torch.clamp(sq, min=1e-24)))


def project_atoms(d: torch.Tensor, constraint: str = "l2ball") -> torch.Tensor:
    """Per-atom projection of a dictionary ``(K, H, W, C)`` or ``(K, M)``.

    'l2sphere': each atom to unit l2 norm; 'l2ball': inside the unit l2
    ball; 'l1ball': on a 4-D D each (atom, channel) plane onto the unit l1
    ball (the reference's per-channel row view), by bisection above 4096
    columns and by the sort below, while a 2-D D keeps the whole-row
    projection.
    """
    k = d.shape[0]
    if constraint == "l1ball" and d.dim() == 4:
        kk, h, w, c = d.shape
        rows = d.permute(0, 3, 1, 2).reshape(kk * c, h * w)
        out = (l1_ball_project_bisect(rows, 1.0) if rows.shape[1] > 4096
               else l1_ball_project(rows, 1.0))
        return out.reshape(kk, c, h, w).permute(0, 2, 3, 1).contiguous()
    flat = d.reshape(k, -1)
    if constraint == "l2sphere":
        out = l2_sphere_project(flat, 1.0, axis=1)
    elif constraint == "l2ball":
        out = l2_ball_project(flat, 1.0, axis=1)
    elif constraint == "l1ball":
        out = (l1_ball_project_bisect(flat, 1.0) if flat.shape[1] > 4096
               else l1_ball_project(flat, 1.0))
    else:
        raise ValueError(f"unknown dictionary constraint: {constraint}")
    return out.reshape(d.shape)


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
