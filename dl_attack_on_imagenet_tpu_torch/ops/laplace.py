"""Laplace fitting and sampling for ADILR's unsupervised inference.

Port of ``dl_attack_on_imagenet_tpu/ops/laplace.py``. The MLE Laplace fit is
closed form: loc is the sample median, scale the mean absolute deviation
from it. The median of an even count is the midpoint of the two middle
values, as ``jnp.median`` computes it (``torch.median`` would return the
lower one). The class-conditioned fits are a numpy copy, a one-time setup
cost.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median along ``dim``, the two middle values averaged for an even count."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    return (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5


def laplace_fit(x: torch.Tensor, min_scale: float = 1e-3):
    """MLE Laplace fit over all elements of ``x``: scalar (loc, scale)."""
    flat = x.reshape(-1)
    loc = _median(flat, 0)
    scale = torch.mean(torch.abs(flat - loc))
    return loc, torch.clamp(scale, min=min_scale)


def laplace_fit_per_atom(v: torch.Tensor, min_scale: float = 1e-3):
    """Column-wise Laplace fit of codes ``v`` (N, K): loc (K,), scale (K,)."""
    loc = _median(v, 0)
    scale = torch.mean(torch.abs(v - loc[None, :]), dim=0)
    return loc, torch.clamp(scale, min=min_scale)


def laplace_fit_conditioned(v: np.ndarray, groups: np.ndarray, num_groups: int,
                            min_scale: float = 1e-3):
    """Per-group, per-atom Laplace fit of codes ``v`` (N, K) by ``groups``
    (N,) (true labels or predictions): loc and scale (num_groups, K) float32.

    Groups with no rows get loc 0 and scale ``min_scale``; rows whose group
    lies outside [0, num_groups) join none. Vectorized: rows are ordered by
    (group, value) per column with two stable argsorts, each group's median
    read at its centre, and the mean absolute deviation summed per group.
    """
    v = np.asarray(v, dtype=np.float64)
    groups = np.asarray(groups)
    in_range = (groups >= 0) & (groups < num_groups)
    if not in_range.all():
        v = v[in_range]
        groups = groups[in_range]
    n, k = v.shape
    loc = np.zeros((num_groups, k), dtype=np.float32)
    scale = np.full((num_groups, k), min_scale, dtype=np.float32)
    if n == 0:
        return loc, scale

    counts = np.bincount(groups, minlength=num_groups)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nonempty = counts > 0

    ord_v = np.argsort(v, axis=0, kind="stable")
    ord_g = np.argsort(groups[ord_v], axis=0, kind="stable")
    final = np.take_along_axis(ord_v, ord_g, axis=0)
    sorted_vals = np.take_along_axis(v, final, axis=0)

    cnz = np.maximum(counts, 1)
    # Empty groups may sit past the last row: clip, and mask them below.
    lo = np.minimum(offsets + (cnz - 1) // 2, n - 1)
    hi = np.minimum(offsets + cnz // 2, n - 1)
    med = 0.5 * (sorted_vals[lo, :] + sorted_vals[hi, :])

    abs_dev = np.abs(v - med[groups])
    seg = np.zeros((num_groups, k), dtype=np.float64)
    np.add.at(seg, groups, abs_dev)
    mad = seg[nonempty] / counts[nonempty, None]

    loc[nonempty] = med[nonempty].astype(np.float32)
    scale[nonempty] = np.maximum(mad, min_scale).astype(np.float32)
    return loc, scale


def laplace_fit_conditioned_direct(v: np.ndarray, groups: np.ndarray, num_groups: int,
                                   min_scale: float = 1e-3):
    """The per-group loop that :func:`laplace_fit_conditioned` vectorizes;
    its test oracle."""
    v = np.asarray(v)
    groups = np.asarray(groups)
    k = v.shape[1]
    loc = np.zeros((num_groups, k), dtype=np.float32)
    scale = np.full((num_groups, k), min_scale, dtype=np.float32)
    for g in range(num_groups):
        rows = v[groups == g]
        if rows.shape[0] == 0:
            continue
        med = np.median(rows, axis=0)
        loc[g] = med
        scale[g] = np.maximum(np.mean(np.abs(rows - med[None, :]), axis=0), min_scale)
    return loc, scale


def laplace_sample(generator: Optional[torch.Generator], loc, scale, shape,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """Laplace(loc, scale) draws of ``shape`` by the inverse CDF, with u
    uniform in (-0.5 + 1e-7, 0.5 - 1e-7) from ``generator``. ``loc`` and
    ``scale`` broadcast against ``shape``; ``device`` defaults to the
    generator's."""
    device = generator.device if device is None else device
    lo, hi = -0.5 + 1e-7, 0.5 - 1e-7
    r = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = torch.clamp(lo + r * (hi - lo), min=lo)
    loc = torch.as_tensor(loc, dtype=dtype, device=device)
    scale = torch.as_tensor(scale, dtype=dtype, device=device)
    return loc - scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
