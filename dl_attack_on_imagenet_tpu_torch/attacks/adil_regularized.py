"""ADILR — regularized Adversarial Dictionary Learning.

Port of ``dl_attack_on_imagenet_tpu/attacks/adil_regularized.py``. Instead
of hard eps-ball constraints, an l1 penalty on the codes (``lambda_l1``) and
an l2 penalty on the perturbation Dv (``lambda_l2``), solved by
proximal-gradient methods with backtracking line searches: ``adil_fb``
(full batch, Bonettini line search), ``sadil`` and ``sadil_updated``
(stochastic), the AdamW trainer ``adilr_adamw``, and
``learn_coding_vectors`` for fresh codes on unseen images. Unseen images are
attacked by that solver (supervised) or by Laplace-sampled codes under four
conditioning modes (unsupervised).

A ``model`` is any callable from NHWC images to logits, such as a
``VictimModel``. The solvers carry the images' dtype, so they also run in
float64 on the CPU with a ``.double()`` network. The JAX package's
``while_loop``s become Python loops over tensors with one host read an
iteration where no line search runs; each line-search candidate adds one.
The hyper-parameters are rounded to float32 first, as the JAX package
passes them to its compiled solvers.

Kernels. The supervised adversary is ``clip(x + clamp(v·D, ±budget), 0,
1)``, one ``fused_perturb`` launch a batch with eps = budget; each
unsupervised trial is one launch with eps = inf. ``adilr_adamw`` updates D
and v each with one ``fused_adamw_project`` launch a batch (no clamp), then
projects D onto its atom constraint. The in-loop forwards need gradients
and stay plain torch.

Where a solver is given ``stats`` (a dict), it records there its
iterations (or epochs and batches) and its line-search halvings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data import ArrayDataset, as_array_dataset
from ..models import VictimModel
from ..ops import (
    cw_margin_loss,
    dict_apply,
    fused_adamw_project,
    fused_perturb,
    laplace_fit,
    laplace_fit_conditioned,
    laplace_fit_per_atom,
    laplace_sample,
    project_atoms,
    project_codes,
    soft_threshold,
)
from ..utils import ArtifactCache
from .adil_core import AdilConfig, predict_labels
from .base import Attack

Model = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RegularizedConfig:
    """Hyper-parameters of the regularized solvers (the JAX package's)."""

    lambda_l1: float = 0.1
    lambda_l2: float = 0.1
    n_atoms: int = 10
    steps: int = 100
    step_size: float = 0.01
    batch_size: int = 1
    targeted: bool = True
    dict_set: str = "l2ball"
    budget: float = 10 / 255
    trials: int = 100
    # The AdamW trainer's knobs: d and v init, the validation solver's
    # budget, and its loss.
    eps: float = 8 / 255
    alpha: float = 0.0  # the codes' init radius is eps + alpha
    norm: str = "linf"  # 'linf' | 'l2'
    loss: str = "ce"  # 'ce' | 'logits'
    kappa: float = 50.0

    @property
    def coeff(self) -> float:
        return 1.0 if self.targeted else -1.0


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX solvers receive their hypers."""
    return float(np.float32(x))


def _targets(model: Model, images: torch.Tensor, labels: torch.Tensor,
             targeted: bool) -> torch.Tensor:
    """Targeted: the second most probable class (a stable sort, as
    ``jnp.argsort``); else the labels."""
    if not targeted:
        return labels
    with torch.no_grad():
        logits = model(images).float()
    return torch.argsort(logits, dim=-1, stable=True)[:, -2]


def _smooth_loss(model: Model, d, v, images, targets, lam2: float, coeff: float,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``coeff * CE_sum(model(x + Dv), targets) + 0.5 * lam2 * ||Dv||^2``,
    each row weighted by ``weights`` (0 on padded rows) where given. The
    logits are promoted to at least float32, never cast down."""
    dv = dict_apply(v, d)
    logits = model(images + dv)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    ce_per = -F.log_softmax(logits, dim=-1).gather(1, targets[:, None])[:, 0]
    sq_per = torch.sum(dv ** 2, dim=tuple(range(1, dv.dim())))
    if weights is not None:
        ce_per = ce_per * weights
        sq_per = sq_per * weights
    return coeff * torch.sum(ce_per) + 0.5 * lam2 * torch.sum(sq_per)


def _grads(fn, *tensors):
    """``fn(*tensors)`` detached and its gradient in each tensor."""
    leaves = [t.detach().requires_grad_(True) for t in tensors]
    val = fn(*leaves)
    return (val.detach(),) + tuple(torch.autograd.grad(val, leaves))


def _draw_dictionary(generator: Optional[torch.Generator], cfg: RegularizedConfig,
                     images: torch.Tensor, d_init) -> torch.Tensor:
    """The learned dictionary's start: ``d_init`` or a Gaussian draw,
    projected onto the atom constraint."""
    if d_init is None:
        if generator is None:
            raise ValueError("a generator or d_init is needed to start the dictionary")
        d_init = torch.randn((cfg.n_atoms,) + tuple(images.shape[1:]), generator=generator,
                             device=generator.device, dtype=images.dtype)
    d = torch.as_tensor(d_init, dtype=images.dtype, device=images.device)
    return project_atoms(d, cfg.dict_set)


def _norm2(*tensors) -> torch.Tensor:
    return sum(torch.sum(t ** 2) for t in tensors)


# ---------------------------------------------------------------------------
# Deterministic full-batch solver
# ---------------------------------------------------------------------------


def adil_fb(model: Model, images: torch.Tensor, targets: torch.Tensor,
            cfg: RegularizedConfig, generator: Optional[torch.Generator] = None,
            dictionary: Optional[torch.Tensor] = None, niter: Optional[int] = None,
            d_init=None, stats: Optional[dict] = None):
    """Full-batch forward-backward splitting with a Bonettini line search.

    ``dictionary`` freezes D; otherwise D starts from ``d_init`` or a draw
    from ``generator``, projected. Line-search constants delta .5, gamma 1,
    beta .5; the step is 0.9 over a Lipschitz estimate from successive
    gradients (from the third iteration; ``step_size`` before), and the
    search halves at most 50 times. On exhaustion the iterate is the full
    prox step, the track records the last candidate's loss, and the solver
    stops.

    Returns ``(d, v, track)``, ``track`` the loss of each iteration (NaN
    past the last).
    """
    niter = int(niter if niter is not None else cfg.steps)
    learn_d = dictionary is None
    d = _draw_dictionary(generator, cfg, images, d_init) if learn_d else dictionary
    v = torch.zeros((images.shape[0], cfg.n_atoms), dtype=images.dtype, device=images.device)
    delta, gamma, beta = 0.5, 1.0, 0.5
    lam1, lam2, coeff = _f32(cfg.lambda_l1), _f32(cfg.lambda_l2), _f32(cfg.coeff)

    def smooth(d_, v_):
        return _smooth_loss(model, d_, v_, images, targets, lam2, coeff)

    def l1(v_):
        return lam1 * torch.sum(torch.abs(v_))

    def full(d_, v_):
        with torch.no_grad():
            return smooth(d_, v_) + l1(v_)

    d_old, v_old = torch.zeros_like(d), torch.zeros_like(v)
    gd_old, gv_old = torch.zeros_like(d), torch.zeros_like(v)
    loss_ns_old = torch.zeros((), dtype=images.dtype, device=images.device)
    lip = 0.9 / torch.tensor(_f32(cfg.step_size), dtype=images.dtype, device=images.device)
    track = torch.full((niter,), float("nan"), dtype=images.dtype, device=images.device)
    halvings = it = 0
    flag_stop = False
    while it < niter and not flag_stop:
        smooth_val, gd, gv = _grads(smooth, d, v)
        loss_old = smooth_val + l1(v)
        with torch.no_grad():
            if it > 1:
                lip = torch.sqrt(_norm2(gd - gd_old, gv - gv_old)) / torch.sqrt(
                    _norm2(d - d_old, v - v_old) + 1e-24)
            step = 0.9 / torch.clamp(lip, min=1e-12)
            v_new = soft_threshold(v - step * gv, step * lam1)
            d_new = project_atoms(d - step * gd, cfg.dict_set) if learn_d else d
            dir_d, dir_v = d_new - d, v_new - v
            # The reference's h: its non-smooth term is the pre-step l1
            # against the last accepted candidate's.
            h = (torch.sum(dir_d * gd) + torch.sum(dir_v * gv)
                 + 0.5 * (gamma / step) * _norm2(dir_d, dir_v) + l1(v) - loss_ns_old)
        loss_c = full(d_new, v_new)
        accepted = bool(loss_c <= loss_old + beta * h)
        cand_d, cand_v = d_new, v_new
        i = 1
        while not (accepted or flag_stop):
            scale = delta ** i
            cand_d, cand_v = d + scale * dir_d, v + scale * dir_v
            loss_c = full(cand_d, cand_v)
            accepted = bool(loss_c <= loss_old + beta * scale * h)
            flag_stop = i + 1 > 50
            i += 1
        halvings += i - 1
        d_old, v_old, gd_old, gv_old = d, v, gd, gv
        # On exhaustion the full prox step is kept.
        d, v = (cand_d, cand_v) if accepted else (d_new, v_new)
        if accepted:
            loss_ns_old = l1(v)
        track[it] = loss_c
        it += 1
    if stats is not None:
        stats.update(iterations=it, halvings=halvings, exhausted=flag_stop)
    return d, v, track


def _pad_for_batching(images: torch.Tensor, targets: torch.Tensor, bsz: int):
    """Rows padded to a multiple of ``bsz``: ``(images, targets, weights,
    n_batches)``, the padded rows at weight 0."""
    n = images.shape[0]
    n_batches = -(-n // bsz)
    pad = n_batches * bsz - n
    weights = torch.cat([torch.ones(n, dtype=images.dtype, device=images.device),
                         torch.zeros(pad, dtype=images.dtype, device=images.device)])
    if pad:
        images = torch.cat([images, images.new_zeros((pad,) + tuple(images.shape[1:]))])
        targets = torch.cat([targets, targets.new_zeros(pad)])
    return images, targets, weights, n_batches


def _batch_size(cfg: RegularizedConfig, n: int) -> int:
    return min(cfg.batch_size, n) if cfg.batch_size else n


# ---------------------------------------------------------------------------
# Stochastic solvers
# ---------------------------------------------------------------------------


def sadil(model: Model, images: torch.Tensor, targets: torch.Tensor, cfg: RegularizedConfig,
          generator: Optional[torch.Generator] = None, nepochs: Optional[int] = None,
          tol: float = 1e-6, d_init=None, stats: Optional[dict] = None):
    """Stochastic alternating prox steps at a fixed step size (SPRING).

    A batch takes a D prox-gradient step (projected onto ``dict_set``),
    then a v prox-gradient step on its rows at the new D (soft threshold),
    each on that batch's fresh gradient. The loss is re-evaluated on the
    whole set after each epoch; the solver stops on |Δloss| < tol.

    Returns ``(d, v, losses)``.
    """
    nepochs = int(nepochs if nepochs is not None else cfg.steps)
    n = images.shape[0]
    bsz = _batch_size(cfg, n)
    images, targets, weights, n_batches = _pad_for_batching(images, targets, bsz)
    d = _draw_dictionary(generator, cfg, images, d_init)
    v = torch.zeros((images.shape[0], cfg.n_atoms), dtype=images.dtype, device=images.device)
    step, lam1 = _f32(cfg.step_size), _f32(cfg.lambda_l1)
    lam2, coeff = _f32(cfg.lambda_l2), _f32(cfg.coeff)

    def full_loss(d_, v_):
        with torch.no_grad():
            return float(_smooth_loss(model, d_, v_, images, targets, lam2, coeff, weights)
                         + lam1 * torch.sum(torch.abs(v_)))

    losses = [full_loss(d, v)]
    epochs = 0
    for _ in range(nepochs):
        for b in range(n_batches):
            sl = slice(b * bsz, (b + 1) * bsz)
            x, t, w = images[sl], targets[sl], weights[sl]
            _, g_d = _grads(lambda d_: _smooth_loss(model, d_, v[sl], x, t, lam2, coeff, w), d)
            with torch.no_grad():
                d = project_atoms(d - step * g_d, cfg.dict_set)
            _, g_v = _grads(lambda vr: _smooth_loss(model, d, vr, x, t, lam2, coeff, w), v[sl])
            with torch.no_grad():
                v[sl] = soft_threshold(v[sl] - step * g_v, step * lam1)
        epochs += 1
        losses.append(full_loss(d, v))
        if abs(losses[-1] - losses[-2]) < tol:
            break
    if stats is not None:
        stats.update(epochs=epochs, batches=epochs * n_batches, halvings=0)
    return d, v[:n], losses


def sadil_updated(model: Model, images: torch.Tensor, targets: torch.Tensor,
                  cfg: RegularizedConfig, generator: Optional[torch.Generator] = None,
                  nepochs: Optional[int] = None, tol: float = 1e-6, d_init=None,
                  stats: Optional[dict] = None):
    """Large-scale stochastic variant with step-size adaptation.

    An epoch takes a v prox step on each batch, with a search of at most 5
    halvings that only adapts step_v (the full prox step is kept either way;
    the halvings count only where the last damped candidate beat the full
    step, and the candidates' l1 term is unscaled, as in the reference). The
    D gradients at each batch's new codes are summed over the epoch, and D
    takes one prox step with its own search under the same rule for step_D.
    While the summed gradient's max is under 1e-4 the D step is skipped, no
    loss is recorded, the convergence test does not run, and the gradient
    goes on accumulating into the next epoch.

    Returns ``(d, v, losses)``.
    """
    nepochs = int(nepochs if nepochs is not None else cfg.steps)
    n = images.shape[0]
    bsz = _batch_size(cfg, n)
    images, targets, weights, n_batches = _pad_for_batching(images, targets, bsz)
    delta, beta = 0.5, 0.5
    d = _draw_dictionary(generator, cfg, images, d_init)
    v = torch.zeros((images.shape[0], cfg.n_atoms), dtype=images.dtype, device=images.device)
    step_v = torch.tensor(cfg.step_size, dtype=images.dtype, device=images.device)
    step_d = step_v.clone()
    lam1, lam2, coeff = _f32(cfg.lambda_l1), _f32(cfg.lambda_l2), _f32(cfg.coeff)

    def full(d_, v_):
        with torch.no_grad():
            return (_smooth_loss(model, d_, v_, images, targets, lam2, coeff, weights)
                    + lam1 * torch.sum(torch.abs(v_)))

    losses = [float(full(d, v))]
    g_d_pending = torch.zeros_like(d)
    halvings = epochs = d_steps = 0
    for _ in range(nepochs):
        i_max = 0
        g_d_epoch = torch.zeros_like(d)
        for b in range(n_batches):
            sl = slice(b * bsz, (b + 1) * bsz)
            x, t, w = images[sl], targets[sl], weights[sl]

            def batch_smooth(d_, vr):
                return _smooth_loss(model, d_, vr, x, t, lam2, coeff, w)

            v_rows = v[sl]
            loss_old, g_v = _grads(lambda vr: batch_smooth(d, vr), v_rows)
            with torch.no_grad():
                loss_old = loss_old + lam1 * torch.sum(torch.abs(v_rows))
                v_new = soft_threshold(v_rows - step_v * g_v, step_v * lam1)
                loss_cur = batch_smooth(d, v_new) + lam1 * torch.sum(torch.abs(v_new))
                # The reference's l1 difference is taken after the prox step
                # is assigned, so it is 0 and the term is absent.
                dh = (torch.sum(g_v * (v_new - v_rows))
                      + 0.5 / step_v * torch.sum((v_new - v_rows) ** 2))
                i, loss_c, dh_c = 0, loss_cur, dh
                while i < 5 and bool(loss_c > loss_old + dh_c * beta):
                    i += 1
                    v_try = (delta ** i) * v_new + (1 - delta ** i) * v_rows
                    loss_c = batch_smooth(d, v_try) + torch.sum(torch.abs(v_try))
                    dh_c = dh_c * delta
                halvings += i
                v[sl] = v_new
                if i and bool(loss_cur > loss_c):
                    i_max = max(i_max, i)
            _, g_d = _grads(lambda d_: batch_smooth(d_, v_new), d)
            g_d_epoch = g_d_epoch + g_d
        epochs += 1
        step_v = torch.clamp(step_v * delta ** i_max, min=1e-5)
        g_d_pending = g_d_pending + g_d_epoch
        if float(torch.max(torch.abs(g_d_pending))) < 1e-4:
            continue
        with torch.no_grad():
            loss_old = full(d, v)
            d_new = project_atoms(d - step_d * g_d_pending, cfg.dict_set)
            loss_cur = full(d_new, v)
            dh = (torch.sum(g_d_pending * (d_new - d))
                  + 0.5 / step_d * torch.sum((d_new - d) ** 2))
            i, loss_c, dh_c = 0, loss_cur, dh
            while i < 5 and bool(loss_c > loss_old + dh_c * beta):
                i += 1
                loss_c = full((delta ** i) * d_new + (1 - delta ** i) * d, v)
                dh_c = dh_c * delta
            halvings += i
            # The full step is kept either way; step_D shrinks, and the
            # damped loss is recorded, only where the damped candidate won.
            use_damped = bool(loss_cur > loss_c)
            if use_damped:
                step_d = torch.clamp(step_d * delta ** i, min=1e-6)
            d = d_new
        d_steps += 1
        g_d_pending = torch.zeros_like(d)
        losses.append(float(loss_c if use_damped else loss_cur))
        if abs(losses[-1] - losses[-2]) < tol:
            break
    if stats is not None:
        stats.update(epochs=epochs, batches=epochs * n_batches, d_steps=d_steps,
                     halvings=halvings)
    return d, v[:n], losses


# ---------------------------------------------------------------------------
# The AdamW trainer
# ---------------------------------------------------------------------------


def adilr_adamw(model: Model, images: torch.Tensor, cfg: RegularizedConfig,
                generator: Optional[torch.Generator] = None, val_images=None,
                nepochs: Optional[int] = None, tol: float = 1e-6, shuffle: bool = True,
                d_init=None, v_init=None, perms: Optional[Sequence] = None,
                stats: Optional[dict] = None):
    """Joint AdamW on (D, v), the reference ADILR's executed trainer.

    AdamW at lr ``step_size`` (betas 0.9/0.999, eps 1e-8, weight decay
    1e-2) on ``coeff * CE_sum + 0.5 * lambda_l2 * ||Dv||^2`` (or the CW
    margin sum with ``loss="logits"``) against the clean predictions,
    computed once. Each batch launches ``fused_adamw_project`` on D and on
    v with no clamp, then projects D onto its atom constraint; v is not
    projected. After each epoch the fresh-code validation of ``ADIL``
    (``val_fooled``, eps ``cfg.eps``) scores ``val_images`` where given;
    the run stops once ``ep > 1`` and |Δloss| < tol.

    D starts from ``d_init`` or a draw (l2: a projected Gaussian; else
    U(-1, 1)), v from ``v_init`` or projected U(0, 1) rows; each epoch's
    order is ``perms[ep]`` where given, else a ``generator`` permutation
    (``shuffle``) or the identity.

    Returns ``(d, v, losses, fooling_rates, val_fools)``, the losses and
    rates normalized by the number of images.
    """
    from .adil import val_fooled

    nepochs = int(nepochs if nepochs is not None else cfg.steps)
    dev = images.device
    n = images.shape[0]
    bsz = _batch_size(cfg, n)
    labels = predict_labels(model, images)
    images_p, labels_p, weights, n_batches = _pad_for_batching(images, labels, bsz)
    n_p = images_p.shape[0]
    shape = (cfg.n_atoms,) + tuple(images.shape[1:])
    if d_init is not None:
        d = torch.as_tensor(d_init, dtype=images.dtype, device=dev).clone()
    elif cfg.norm.lower() == "l2":
        d = project_atoms(torch.randn(shape, generator=generator, device=dev), cfg.dict_set)
    else:
        d = torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0
    if v_init is not None:
        v = torch.as_tensor(v_init, dtype=images.dtype, device=dev)
        v = torch.cat([v, v.new_zeros((n_p - n, cfg.n_atoms))])
    else:
        v = project_codes(torch.rand((n_p, cfg.n_atoms), generator=generator, device=dev),
                          cfg.eps + cfg.alpha, cfg.norm)
    d, v = d.contiguous(), v.contiguous()
    d_mu, d_nu = torch.zeros_like(d), torch.zeros_like(d)
    v_mu, v_nu = torch.zeros_like(v), torch.zeros_like(v)
    lr, lam2, coeff = _f32(cfg.step_size), _f32(cfg.lambda_l2), _f32(cfg.coeff)
    kappa = _f32(cfg.kappa)

    data_val = val_cfg = None
    if val_images is not None:
        val_np = (val_images.detach().cpu().numpy() if isinstance(val_images, torch.Tensor)
                  else np.asarray(val_images, np.float32))
        data_val = ArrayDataset(val_np, np.zeros(val_np.shape[0], np.int64))
        # One solve over the whole val set, as the JAX package runs it.
        val_cfg = AdilConfig(eps=cfg.eps, norm=cfg.norm, n_atoms=cfg.n_atoms, loss=cfg.loss,
                             kappa=cfg.kappa, targeted=cfg.targeted,
                             batch_size=val_np.shape[0])

    def loss_fn(d_, v_, x, t, w, idx):
        dv = dict_apply(v_[idx], d_)
        logits = model(x + dv).float()
        if cfg.loss == "ce":
            per = -F.log_softmax(logits, dim=-1).gather(1, t[:, None])[:, 0]
            smooth = coeff * torch.sum(per * w)
        else:
            smooth = torch.sum(cw_margin_loss(logits, t, kappa=kappa,
                                              targeted=cfg.targeted) * w)
        sq = torch.sum(dv ** 2, dim=tuple(range(1, dv.dim())))
        return smooth + 0.5 * lam2 * torch.sum(sq * w), logits

    count = 0
    losses: List[float] = []
    fooling_rates: List[float] = []
    val_fools: List[float] = []
    for ep in range(nepochs):
        if perms is not None:
            perm = torch.as_tensor(np.array(perms[ep]), dtype=torch.int64, device=dev)
        elif shuffle:
            perm = torch.randperm(n_p, generator=generator, device=generator.device).to(dev)
        else:
            perm = torch.arange(n_p, device=dev)
        loss_sum = torch.zeros((), device=dev)
        fool_sum = torch.zeros((), device=dev)
        for b in range(n_batches):
            idx = perm[b * bsz:(b + 1) * bsz]
            x, t, w = images_p[idx], labels_p[idx], weights[idx]
            d_ = d.detach().requires_grad_(True)
            v_ = v.detach().requires_grad_(True)
            loss, logits = loss_fn(d_, v_, x, t, w, idx)
            g_d, g_v = torch.autograd.grad(loss, [d_, v_])
            with torch.no_grad():
                count += 1
                fused_adamw_project(d, g_d.contiguous(), d_mu, d_nu, count, lr, float("inf"))
                fused_adamw_project(v, g_v.contiguous(), v_mu, v_nu, count, lr, float("inf"))
                d.copy_(project_atoms(d, cfg.dict_set))
                loss_sum += loss.detach()
                fool_sum += torch.sum((torch.argmax(logits, -1) != t).to(w.dtype) * w)
        sums = torch.stack([loss_sum, fool_sum]).tolist()  # the epoch's one host read
        losses.append(sums[0] / n)
        fooling_rates.append(sums[1] / n)
        if data_val is not None:
            val_fools.append(float(val_fooled(model, d, data_val, val_cfg, dev))
                             / len(data_val))
        if ep > 1 and abs(losses[-1] - losses[-2]) < tol:
            break
    if stats is not None:
        stats.update(epochs=len(losses), batches=count, halvings=0)
    return d, v[:n], losses, fooling_rates, val_fools


# ---------------------------------------------------------------------------
# Inference-time coding-vector solver
# ---------------------------------------------------------------------------


def learn_coding_vectors(model: Model, d: torch.Tensor, images: torch.Tensor,
                         targets: torch.Tensor, cfg: RegularizedConfig, niter: int = 100,
                         step_size: float = 100.0, tol: float = 1e-6,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """Prox-gradient on fresh codes v against a frozen dictionary.

    Each iteration searches at most 10 halvings (delta .9) and takes the
    damped candidate only where it is accepted and beats the full prox
    step, then shrinks the step; on exhaustion it keeps the last damped
    candidate and does not shrink. It stops after ``niter`` iterations or
    once the loss improves by less than ``tol``.
    """
    delta, gamma, beta = 0.9, 1.0, 0.5
    lam1, lam2, coeff = _f32(cfg.lambda_l1), _f32(cfg.lambda_l2), _f32(cfg.coeff)
    acc_t = torch.promote_types(torch.float32, images.dtype)
    tol = _f32(tol)

    def smooth(v_):
        dv = dict_apply(v_, d)
        logits = model(images + dv).to(acc_t)
        ce = -torch.sum(F.log_softmax(logits, dim=-1).gather(1, targets[:, None]))
        return coeff * ce + 0.5 * lam2 * torch.sum(dv ** 2)

    def l1(v_):
        return lam1 * torch.sum(torch.abs(v_))

    def full(v_):
        with torch.no_grad():
            return smooth(v_) + l1(v_)

    v = torch.zeros((images.shape[0], d.shape[0]), dtype=images.dtype, device=images.device)
    step = torch.tensor(_f32(step_size), dtype=acc_t, device=images.device)
    loss_prev = torch.tensor(float("inf"), dtype=acc_t, device=images.device)
    halvings = it = 0
    stop = False
    while it < niter and not stop:
        smooth_val, g = _grads(smooth, v)
        with torch.no_grad():
            loss_old = smooth_val + l1(v)
            v_new = soft_threshold(v - step * g, step * lam1)
            dvv = v_new - v
            h = (torch.sum(dvv * g) + 0.5 * (gamma / step) * torch.sum(dvv ** 2)
                 + l1(v_new) - l1(v))
        loss_cur0 = full(v_new)
        # One read: the full step's acceptance and, were it accepted, the stop.
        accepted, stop = torch.stack([loss_cur0 <= loss_old + beta * h,
                                      (loss_prev - loss_cur0) < tol]).tolist()
        if accepted:
            v, loss_next = v_new, loss_cur0
        else:
            i = 1
            while not accepted and i <= 10:
                scale = delta ** i
                v_try = v + scale * dvv
                loss_try = full(v_try)
                accepted = bool(loss_try <= loss_old + beta * scale * h)
                i += 1
            halvings += i - 1
            # Damped and better than the full step: take it and shrink the
            # step; exhausted: keep the last damped candidate, same step.
            use_damped = accepted and bool(loss_cur0 > loss_try)
            if use_damped or not accepted:
                v, loss_next = v_try, loss_try
            else:
                v, loss_next = v_new, loss_cur0
            if use_damped:
                step = step * delta ** (i - 1)
            stop = bool((loss_prev - loss_next) < tol)
        loss_prev = loss_next
        it += 1
    if stats is not None:
        stats.update(iterations=it, halvings=halvings)
    return v


# ---------------------------------------------------------------------------
# Unsupervised inference: best of Laplace trials
# ---------------------------------------------------------------------------


@torch.no_grad()
def best_of_trials(model: Model, d: torch.Tensor, images: torch.Tensor, loc, scale,
                   trials: int, generator: Optional[torch.Generator] = None,
                   draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Best adversary of ``trials`` Laplace-drawn codes for each image.

    ``loc`` and ``scale`` broadcast to (N, K). Each trial is one
    ``fused_perturb`` launch with eps = inf, ``clip(x + v·D, 0, 1)``. Per
    image: once a draw fools the model, keep the least-MSE fooling
    adversary; until then the least-MSE non-fooling one. ``draws``
    ((trials, N, K)) replaces the sampler, and then ``generator`` may be
    None.
    """
    n, k = images.shape[0], d.shape[0]
    dev = images.device
    if draws is None:
        loc = torch.as_tensor(loc, dtype=torch.float32, device=dev).expand(n, k)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev).expand(n, k)
        draws = laplace_sample(generator, loc, scale, (trials, n, k), device=dev)
    pre = torch.argmax(model(images).float(), dim=-1)
    fooled = torch.zeros(n, dtype=torch.bool, device=dev)
    mse_fool = torch.full((n,), float("inf"), device=dev)
    mse_nofool = torch.full((n,), float("inf"), device=dev)
    best = torch.zeros_like(images)
    pixel_axes = tuple(range(1, images.dim()))
    for v in draws:
        adv = fused_perturb(torch.as_tensor(v, dtype=images.dtype, device=dev).contiguous(),
                            d, images, float("inf"))
        fooling = torch.argmax(model(adv).float(), dim=-1) != pre
        mse = torch.sum((images - adv) ** 2, dim=pixel_axes)
        take_fool = fooling & (mse < mse_fool)
        take_nofool = ~fooled & ~fooling & (mse < mse_nofool)
        mse_fool = torch.where(take_fool, mse, mse_fool)
        mse_nofool = torch.where(take_nofool, mse, mse_nofool)
        take = (take_fool | take_nofool).reshape((n,) + (1,) * (images.dim() - 1))
        best = torch.where(take, adv, best)
        fooled = fooled | fooling
    return best


# ---------------------------------------------------------------------------
# The attack class
# ---------------------------------------------------------------------------


class ADILR(Attack):
    """Regularized ADiL with Laplace-sampled unsupervised inference.

    The dictionary is learned by ``version``: ``"deterministic"``
    (``adil_fb``), ``"adamw"`` (``adilr_adamw``) or any other
    (``sadil_updated``); the artifact ``{d, v, loss, labels}`` is the JAX
    package's, keyed by model, lambdas, atoms, steps and ``param_or_train``.
    ``attack="supervised"`` solves fresh codes for each batch; otherwise
    codes are drawn from the Laplace fit of the learned ones under
    ``attack_conditioned``: ``"none"``, ``"atoms"``, ``"labels_atoms"`` or
    ``"predictions_atoms"``.
    """

    CONDITIONING = ("predictions_atoms", "labels_atoms", "atoms", "none")

    def __init__(
        self,
        victim: VictimModel,
        steps: int = 100,
        lambda_l1: float = 1e-1,
        lambda_l2: float = 1e-1,
        version: str = "deterministic",
        targeted: bool = True,
        attack: str = "supervised",
        n_atoms: int = 10,
        batch_size: int = 1,
        data_train=None,
        step_size: float = 0.01,
        trials: int = 100,
        budget: float = 10 / 255,
        model_name: Optional[str] = None,
        param_or_train: str = "param_selecting",
        attack_conditioned: str = "labels_atoms",
        cache: Optional[ArtifactCache] = None,
        seed: int = 0,
        eps: float = 8 / 255,
        alpha: float = 0.0,
        norm: str = "linf",
        loss: str = "ce",
        kappa: float = 50.0,
        data_val=None,
    ):
        super().__init__(victim, "ADILR", targeted)
        self.cfg = RegularizedConfig(
            lambda_l1=lambda_l1, lambda_l2=lambda_l2, n_atoms=n_atoms, steps=int(steps),
            step_size=step_size, batch_size=batch_size, targeted=targeted, budget=budget,
            trials=int(trials), eps=eps, alpha=alpha, norm=norm, loss=loss, kappa=kappa)
        self.data_val = data_val
        self.version = version
        self.attack_mode = attack
        self.attack_conditioned = attack_conditioned
        self.model_name = model_name or victim.name
        self.cache = cache or ArtifactCache("dict_model_ImageNet")
        self.seed = seed
        self.dictionary: Optional[torch.Tensor] = None
        self.mean: Optional[dict] = None
        self.scale: Optional[dict] = None
        self.stats: dict = {}  # the last solver's iterations and halvings
        self._rng_calls = 0
        self._key = dict(model=self.model_name, lam1=lambda_l1, lam2=lambda_l2,
                         atoms=n_atoms, steps=int(steps), tag=param_or_train)
        if not self.cache.exists("ADILR", **self._key) and data_train is not None:
            self.learn_dictionary(data_train)
        elif attack == "unsupervised" and self.cache.exists("ADILR", **self._key):
            self._fit_laplace_from_artifact(data_train)

    @property
    def device(self) -> torch.device:
        return self.victim.device

    @property
    def is_trained(self) -> bool:
        """Whether ``forward`` would skip its lazy learn."""
        return self.dictionary is not None or self.cache.exists("ADILR", **self._key)

    # -- dictionary learning ---------------------------------------------

    def learn_dictionary(self, data_train) -> None:
        """Learn D by ``version``, save the artifact, and fit the Laplace
        conditioning on the learned codes."""
        ds = as_array_dataset(data_train)
        images = torch.as_tensor(ds.images, dtype=torch.float32, device=self.device).contiguous()
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.stats = {}
        if self.version == "deterministic":
            targets = _targets(self.victim, images,
                               torch.tensor(ds.labels, device=self.device), self.targeted)
            d, v, track = adil_fb(self.victim, images, targets, self.cfg, generator,
                                  stats=self.stats)
            losses = track.cpu().numpy()
        elif self.version == "adamw":
            val_images = (None if self.data_val is None
                          else as_array_dataset(self.data_val).images)
            d, v, losses, fooling, val_fools = adilr_adamw(
                self.victim, images, self.cfg, generator, val_images=val_images,
                stats=self.stats)
            self.fooling_rates = fooling
            self.val_fools = val_fools
            losses = np.asarray(losses, np.float32)
        else:
            targets = _targets(self.victim, images,
                               torch.tensor(ds.labels, device=self.device), self.targeted)
            d, v, losses = sadil_updated(self.victim, images, targets, self.cfg, generator,
                                         stats=self.stats)
            losses = np.asarray(losses, np.float32)
        self.dictionary = d.contiguous()
        self.cache.save({"d": d, "v": v, "loss": losses,
                         "labels": np.asarray(ds.labels).astype(np.int32)},
                        "ADILR", **self._key)
        self._fit_laplace(v, ds)

    def _fit_laplace_from_artifact(self, data_train=None) -> None:
        payload = self.cache.load("ADILR", **self._key)
        ds = as_array_dataset(data_train) if data_train is not None else None
        # An artifact without labels falls back to the dataset's.
        labels = payload.get("labels")
        self._fit_laplace(payload["v"], ds, None if labels is None else np.asarray(labels))

    def _fit_laplace(self, v, ds=None, labels: Optional[np.ndarray] = None) -> None:
        """The four conditioning fits: ``none``, ``atoms``, and, where labels
        or a dataset are known, ``labels_atoms`` and ``predictions_atoms``."""
        num_classes = self.victim.num_classes
        v_t = torch.as_tensor(v, dtype=torch.float32)
        v_np = v_t.detach().cpu().numpy()
        loc_a, scale_a = laplace_fit_per_atom(v_t)
        loc_n, scale_n = laplace_fit(v_t)
        self.mean = {"atoms": loc_a.cpu().numpy(), "none": float(loc_n)}
        self.scale = {"atoms": scale_a.cpu().numpy(), "none": float(scale_n)}
        if labels is None and ds is not None:
            labels = np.asarray(ds.labels)
        if labels is not None and labels.size == v_np.shape[0]:
            self.mean["labels_atoms"], self.scale["labels_atoms"] = laplace_fit_conditioned(
                v_np, labels, num_classes)
        if ds is not None:
            preds = predict_labels(self.victim, torch.as_tensor(
                ds.images, dtype=torch.float32, device=self.device)).cpu().numpy()
            self.mean["predictions_atoms"], self.scale["predictions_atoms"] = (
                laplace_fit_conditioned(v_np, preds, num_classes))

    # -- inference --------------------------------------------------------

    def _load_dictionary(self) -> torch.Tensor:
        if self.dictionary is None:
            payload = self.cache.load("ADILR", **self._key)
            if payload is None:
                raise FileNotFoundError("ADILR dictionary has not been learned")
            self.dictionary = torch.as_tensor(payload["d"], dtype=torch.float32,
                                              device=self.device).contiguous()
        return self.dictionary

    def _laplace_params(self, mode: str):
        if self.mean is None or mode not in self.mean:
            raise RuntimeError(f"Laplace fit for '{mode}' unavailable")
        return self.mean[mode], self.scale[mode]

    def _best_of_trials(self, images, loc, scale, generator, draws=None) -> torch.Tensor:
        return best_of_trials(self.victim, self._load_dictionary(), images, loc, scale,
                              self.cfg.trials, generator, draws)

    def forward_unsupervised(self, images, generator=None, draws=None) -> torch.Tensor:
        """conditioned='none': one scalar Laplace for every code."""
        loc, scale = self._laplace_params("none")
        return self._best_of_trials(images, loc, scale, generator, draws)

    def forward_unsupervised_conditioned_atoms(self, images, generator=None,
                                               draws=None) -> torch.Tensor:
        """conditioned='atoms': a Laplace for each atom."""
        loc, scale = self._laplace_params("atoms")
        return self._best_of_trials(images, loc[None, :], scale[None, :], generator, draws)

    def forward_unsupervised_conditioned_target_atoms(self, images, labels, generator=None,
                                                      version: str = "labels",
                                                      draws=None) -> torch.Tensor:
        """conditioned='labels_atoms' / 'predictions_atoms': a Laplace for
        each (class, atom), the class the given label or the prediction."""
        mode = "labels_atoms" if version == "labels" else "predictions_atoms"
        loc_tab, scale_tab = self._laplace_params(mode)
        target = labels if version == "labels" else self.victim.predict(images)
        target = torch.as_tensor(target, device="cpu").long()
        loc = torch.as_tensor(loc_tab)[target]
        scale = torch.as_tensor(scale_tab)[target]
        return self._best_of_trials(images, loc, scale, generator, draws)

    def forward_supervised(self, images, labels) -> torch.Tensor:
        """Fresh codes by ``learn_coding_vectors``, then one ``fused_perturb``
        launch: ``clip(x + clamp(v·D, ±budget), 0, 1)``."""
        d = self._load_dictionary()
        targets = _targets(self.victim, images, labels, self.targeted)
        self.stats = {}
        v = learn_coding_vectors(self.victim, d, images, targets, self.cfg, stats=self.stats)
        return fused_perturb(v.contiguous(), d, images, self.cfg.budget)

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not self.is_trained:
            self.learn_dictionary((images.detach().cpu().numpy(),
                                   labels.detach().cpu().numpy()))
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device).contiguous()
        self._rng_calls += 1
        if self.attack_mode == "supervised":
            return self.forward_supervised(images, labels)
        generator = torch.Generator(device=images.device)
        generator.manual_seed(self.seed * 1_000_003 + self._rng_calls)
        mode = self.attack_conditioned
        if mode == "labels_atoms":
            return self.forward_unsupervised_conditioned_target_atoms(
                images, labels, generator, "labels")
        if mode == "predictions_atoms":
            return self.forward_unsupervised_conditioned_target_atoms(
                images, labels, generator, "predictions")
        if mode == "atoms":
            return self.forward_unsupervised_conditioned_atoms(images, generator)
        return self.forward_unsupervised(images, generator)
