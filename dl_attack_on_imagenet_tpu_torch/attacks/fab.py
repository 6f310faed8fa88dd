"""FAB: Fast Adaptive Boundary attack (l∞), untargeted and targeted.

Port of ``dl_attack_on_imagenet_tpu/attacks/fab.py`` (Croce & Hein, ICML
2019, with the released alpha_max = 0.1, eta = 1.05, beta = 0.9). Each step
linearizes f_c = z_c - z_y at the iterate for the top ``n_classes - 1``
other classes (the target alone when targeted), picks the candidate of least
|f_c| / ||w_c||_1, projects both the iterate and the original point onto its
linearized boundary inside the [0, 1] box, exactly in l∞, and moves to the
alpha-mix of the two extrapolated projections; a misclassified iterate is
recorded if it is the closest so far and then pulled back toward the
original. FAB minimizes distortion: ``eps`` only sizes the restarts.

The Jacobian of f_c comes from one batched forward and one backward of
``sum_i f_{i, c_ij}`` per candidate j: the victim runs in inference mode, so
no row of the batch depends on another and row i of the j-th backward is
image i's gradient alone (the argument of
:func:`.deepfool.selected_jacobian`). The box projection on the path is the
safeguarded Newton waterfill, a few elementwise passes and reductions over
the winner's row, one host read an iteration;
:func:`linf_hyperplane_box_project` is the sort/cumsum waterfill, kept as
the small-shape reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models import VictimModel
from .base import Seeded
from .deepfool import forward_with_graph

ALPHA_MAX = 0.1
ETA = 1.05
BETA = 0.9


def _direction_and_room(x, w, hval, inf_room: bool):
    """Each coordinate's direction ``-sign(hval) sign(w_i)`` and its room to
    the box wall that way; a coordinate that does not move gets room inf
    (the sort form) or 0 (the Newton form)."""
    s = -torch.sign(hval)[..., None] * torch.sign(w)
    rest = torch.inf if inf_room else 0.0
    room = torch.where(s > 0, 1.0 - x, torch.where(s < 0, x, rest))
    return s, room


def linf_hyperplane_box_project(x, w, hval):
    """Exact min-l∞ move of ``x`` (in [0, 1]^d) onto {z: h(z) = 0} for
    h(z) = hval + <w, z - x>, inside the box, by the sort waterfill.

    Every coordinate moves against sign(hval) sign(w_i) by up to t and
    saturates at its wall after room_i; G(t) = sum_i |w_i| min(t, room_i)
    is solved for |hval| at the sorted knots. Returns (delta, t*), t* = inf
    where the hyperplane cannot be reached in the box. Batched over the
    leading dims of x, w (..., d) and hval (...).
    """
    a = torch.abs(w)
    s, room = _direction_and_room(x, w, hval, inf_room=True)
    # w_i == 0 contributes nothing: infinite room, so it never caps G.
    room = torch.where(a > 0, room, torch.inf)
    target = torch.abs(hval)

    order = torch.argsort(room, dim=-1, stable=True)
    r_s = room.gather(-1, order)
    a_s = a.gather(-1, order)
    finite = torch.isfinite(r_s)
    total = torch.sum(a_s, dim=-1, keepdim=True)
    pre_a = torch.cumsum(a_s, dim=-1)
    pre_ar = torch.cumsum(a_s * torch.where(finite, r_s, 0.0), dim=-1)
    g_knot = pre_ar + torch.where(finite, (total - pre_a) * r_s, 0.0)

    reach = g_knot >= target[..., None]
    k = torch.argmax(reach.to(torch.int32), dim=-1)  # the first knot that reaches
    any_reach = reach.any(dim=-1)

    def before_k(v):
        prev = v.gather(-1, torch.clamp(k - 1, min=0)[..., None])[..., 0]
        return torch.where(k > 0, prev, 0.0)

    slope = total[..., 0] - before_k(pre_a)
    t = (target - before_k(pre_ar)) / torch.clamp(slope, min=1e-30)
    t = torch.where(any_reach, torch.clamp(t, min=0.0), torch.inf)

    move = torch.minimum(t[..., None], room)
    delta = torch.where((s != 0) & torch.isfinite(move), s * move, 0.0)
    delta = torch.where(torch.isfinite(t[..., None]), delta, 0.0)
    return delta, t


def linf_hyperplane_box_project_t(x, w, hval, max_iters: int = 64):
    """t* of :func:`linf_hyperplane_box_project` by safeguarded Newton.

    G is concave, piecewise linear and nondecreasing, so Newton from t = 0
    climbs to t* from below; the loop ends once no row's step exceeds
    1e-6 t, or after ``max_iters`` steps (every row steps on each pass, as
    in the JAX package). Returns t* with inf where the box cannot reach the
    hyperplane.
    """
    a = torch.abs(w)
    _, room = _direction_and_room(x, w, hval, inf_room=False)
    target = torch.abs(hval)
    feasible = torch.sum(a * room, dim=-1) >= target
    t = torch.zeros_like(target)
    active = feasible
    i = 0
    while i < max_iters and bool(active.any()):
        te = t[..., None]
        g = torch.sum(a * torch.minimum(te, room), dim=-1)
        gp = torch.sum(torch.where(room > te, a, 0.0), dim=-1)
        step = torch.where(feasible, torch.clamp(target - g, min=0.0)
                           / torch.clamp(gp, min=1e-30), 0.0)
        t = t + step
        active = step > 1e-6 * t
        i += 1
    return torch.where(feasible, t, torch.inf)


def linf_hyperplane_box_delta(x, w, hval, t):
    """The projection's move for a known t*: each coordinate moves against
    sign(hval) sign(w_i) by min(t*, room_i); zero where t* is infinite."""
    s, room = _direction_and_room(x, w, hval, inf_room=False)
    move = torch.minimum(t[..., None], room)
    return torch.where((s != 0) & torch.isfinite(t)[..., None], s * move, 0.0)


def _fab_run(model, images, labels, x0, targets, steps: int, n_cand: int, targeted: bool,
             stats: Optional[dict] = None):
    """One FAB run from ``x0``. Returns (x_best, d_best, found). With
    ``stats``, ``stats["chosen"]`` gets each step's chosen candidate class
    of every image (host arrays)."""
    x = images.float()
    n = x.shape[0]
    x_flat = x.reshape(n, -1)
    rows = torch.arange(n, device=x.device)

    def f_and_jac(u):
        """(f (n, K), its Jacobian (n, K, d), the candidate classes (n, K))."""
        xg, logits = forward_with_graph(model, u)
        if targeted:
            cands = targets[:, None]
        else:
            hot = F.one_hot(labels, logits.shape[-1]) > 0
            masked = torch.where(hot, -torch.inf, logits.detach())
            cands = torch.argsort(masked, dim=-1, stable=True)[:, -n_cand:]
        k = cands.shape[1]
        with torch.enable_grad():
            sel = logits.gather(1, cands) - logits.gather(1, labels[:, None])
            jac = [torch.autograd.grad(sel[:, j].sum(), xg, retain_graph=j < k - 1)[0]
                   for j in range(k)]
        return sel.detach(), torch.stack(jac, 1).reshape(n, k, -1), cands

    def cap(t):
        # A winner the box cannot reach saturates every coordinate toward
        # its boundary (t = 1 covers every room in the unit box).
        return torch.where(torch.isfinite(t), t, 1.0)

    x_i = x0.float()
    x_best = x
    d_best = torch.full((n,), torch.inf, device=x.device)
    found = torch.zeros(n, dtype=torch.bool, device=x.device)
    for _ in range(steps):
        f, w, cands = f_and_jac(x_i)
        dist1 = torch.abs(f) / torch.clamp(torch.sum(torch.abs(w), dim=-1), min=1e-12)
        best_c = torch.argmin(dist1, dim=-1)
        w_b, f_b = w[rows, best_c], f[rows, best_c]
        xi_f = x_i.reshape(n, -1)
        t_i = cap(linf_hyperplane_box_project_t(xi_f, w_b, f_b))
        d_i = linf_hyperplane_box_delta(xi_f, w_b, f_b, t_i)
        # The same linear model, projected from the original point.
        h_b = f_b + torch.sum(w_b * (x_flat - xi_f), dim=-1)
        t_o = cap(linf_hyperplane_box_project_t(x_flat, w_b, h_b))
        d_o = linf_hyperplane_box_delta(x_flat, w_b, h_b, t_o)
        ni = torch.amax(torch.abs(d_i), dim=-1)
        no = torch.amax(torch.abs(d_o), dim=-1)
        alpha = torch.clamp(ni / torch.clamp(ni + no, min=1e-12), 0.0, ALPHA_MAX)
        x_new = ((1.0 - alpha)[:, None] * (xi_f + ETA * d_i)
                 + alpha[:, None] * (x_flat + ETA * d_o))
        x_new = torch.clamp(x_new, 0.0, 1.0).reshape(x.shape)

        with torch.no_grad():
            pred = torch.argmax(model(x_new).float(), dim=-1)
        # Success is misclassification in both modes (FAB-T restricts only
        # the linearization to the target).
        fooled = pred != labels
        dist = torch.amax(torch.abs(x_new - x).reshape(n, -1), dim=-1)
        better = fooled & (dist < d_best)
        x_best = torch.where(better[:, None, None, None], x_new, x_best)
        d_best = torch.where(better, dist, d_best)
        found = found | fooled
        x_i = torch.where(fooled[:, None, None, None], (1.0 - BETA) * x + BETA * x_new, x_new)
        if stats is not None:
            stats.setdefault("chosen", []).append(cands[rows, best_c].cpu().numpy())
    return x_best.to(images.dtype), d_best, found


class FAB(Seeded):
    def __init__(self, victim: VictimModel, norm: str = "Linf", eps: float = 8 / 255,
                 steps: int = 10, n_restarts: int = 1, alpha_max: float = ALPHA_MAX,
                 eta: float = ETA, beta: float = BETA, n_classes: int = 10,
                 targeted: bool = False, seed: int = 0):
        super().__init__(victim, "FAB", targeted, seed)
        if norm.lower() != "linf":
            raise ValueError("FAB: only norm='Linf' is implemented")
        if (alpha_max, eta, beta) != (ALPHA_MAX, ETA, BETA):
            raise ValueError("alpha_max/eta/beta are fixed at the paper's 0.1/1.05/0.9")
        self.eps, self.steps, self.n_restarts = eps, steps, n_restarts
        self.n_classes = n_classes
        self.n_cand = 1 if targeted else max(n_classes - 1, 1)

    @staticmethod
    def _restart_point(images, u, radius):
        """A restart at l∞ distance ``radius / 2`` in the direction of the
        U(-1, 1) draw ``u``, clipped to the box."""
        u = u.to(images)
        mx = torch.amax(torch.abs(u), dim=(1, 2, 3), keepdim=True)
        r = radius[:, None, None, None]
        return torch.clamp(images + 0.5 * r * u / torch.clamp(mx, min=1e-12), 0, 1)

    def forward(self, images, labels, draws: Optional[dict] = None, stats=None):
        """``draws`` maps a run's index (counted over target sets, then
        restarts) to its restart draw; the first restart of each target set
        starts at the images and draws nothing."""
        self._rng_calls += 1
        if self.targeted:
            with torch.no_grad():
                order = torch.argsort(self.victim(images), dim=-1, stable=True)
            n_cand = min(self.n_classes - 1, order.shape[-1] - 1)
            target_sets = [order[:, -r] for r in range(2, 2 + n_cand)]
        else:
            target_sets = [labels]
        x_out = images
        d_out = torch.full(images.shape[:1], torch.inf, device=images.device)
        run = 0
        for targets in target_sets:
            for r in range(self.n_restarts):
                if r == 0:
                    x0 = images
                else:
                    radius = torch.clamp(d_out, max=self.eps)  # eps while none found
                    u = draws[run] if draws is not None else (
                        2.0 * torch.rand(images.shape, generator=self._generator(run)) - 1.0)
                    x0 = self._restart_point(images, u, radius)
                run += 1
                xb, db, fnd = _fab_run(self.victim, images, labels, x0, targets, self.steps,
                                       self.n_cand, self.targeted, stats)
                better = fnd & (db < d_out)
                x_out = torch.where(better[:, None, None, None], xb, x_out)
                d_out = torch.where(better, db, d_out)
        return x_out
