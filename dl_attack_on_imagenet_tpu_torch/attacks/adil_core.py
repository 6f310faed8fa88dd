"""ADiL functional core: dictionary learning and attacks with a frozen
dictionary.

Port of ``dl_attack_on_imagenet_tpu/attacks/adil_core.py``. A ``model`` here
is any callable from NHWC [0, 1] images to logits, such as a
``VictimModel``. JAX's ``while_loop``/``scan`` become Python loops.

Training. The state (:class:`TrainState`) holds D flat ``(K, H*W*C)`` in
NHWC pixel order, the codes v, and AdamW moments for each; a step updates
it in place, as JAX's donated state is updated. Both halves of every update
go through the ``fused_adamw_project`` kernel: AdamW, then the clamp to
±1 for D under l∞ (no clamp under l2, where ``project_dictionary`` follows),
and for v no clamp, then ``project_codes``. The loss and fooling count stay
on the device; the caller reads them once per epoch.

Serving. Every adversary that leaves a solver goes through the
``fused_perturb`` kernel: once per unsupervised trial, and once for each
supervised solver's final read-off with ``eps = inf`` (``clip(x + D v, 0,
1)``). The in-loop forwards need gradients and stay plain torch, as the
kernel has no backward; the early stop on ``max|Δ| < tol`` reads one scalar
back to the host per step.

Spans (``utils.profiling``): ``adil/step`` a training step; a solver's
iterations ``adil/ddrague/step`` and ``adil/adamw_codes/step``, each with
its early-stop read ``sync/step_delta``; DDrague's clean labels and D†
``adil/ddrague/labels`` (D†'s solve checks its result on the host:
``sync/dict_pinv``); ``adil/readoff``; sampling's ``adil/sample/labels``,
``adil/sample/draws`` and ``adil/sample/trial``.

Mixed precision (``perturb_dtype="bfloat16"``), the JAX package's contract:
the contractions inside the inner forwards run in bf16 (``batch_loss``'s
``v·D`` added to a bf16 image, DDrague's ``codes_from_pinv`` and
``dict_apply``, the AdamW codes' ``dict_apply``), and the victim normalizes
the bf16 sum in bf16 before its fp32 layers. The master z, v and D, the
AdamW moments, every projection and clamp, and the final read-off stay
fp32: ``fused_adamw_project`` still updates both fp32 halves of a step, and
``fused_perturb`` still reads the adversary off with eps = inf.
Unsupervised sampling has no bf16 branch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import (
    attack_loss,
    codes_from_pinv,
    cw_margin_loss,
    dict_apply,
    dict_pinv,
    fused_adamw_project,
    fused_perturb,
    linf_clamp,
    project_codes,
    project_dictionary,
)
from ..utils.profiling import annotate

Model = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdilConfig:
    """Static attack hyper-parameters (the reference operating point)."""

    eps: float = 8 / 255
    norm: str = "linf"  # 'linf' | 'l2'
    n_atoms: int = 100
    loss: str = "ce"  # 'ce' | 'logits'
    kappa: float = 50.0
    targeted: bool = False
    step_size: float = 0.01
    steps: int = 500
    steps_inner: int = 1
    batch_size: int = 100
    trials: int = 10
    steps_inference: int = 30
    steps_code: int = 100  # inner v-solver iterations
    code_lr: float = 1e-2  # inference-time AdamW lr
    tol: float = 1e-6
    perturb_dtype: str = "float32"  # 'float32' | 'bfloat16' (see the module)

    def __post_init__(self):
        # A typo must not fall back to fp32 unnoticed.
        if self.perturb_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"perturb_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.perturb_dtype!r}")

    @property
    def coeff(self) -> float:
        return 1.0 if self.targeted else -1.0

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """The inner forwards' contraction dtype: None (true fp32) or bf16."""
        return torch.bfloat16 if self.perturb_dtype == "bfloat16" else None


def init_dictionary(generator: torch.Generator, image_shape, cfg: AdilConfig,
                    device=None) -> torch.Tensor:
    """D init: linf -> U(-1, 1); l2 -> unit-ball-projected Gaussian.

    ``device`` defaults to the generator's.
    """
    shape = (cfg.n_atoms,) + tuple(image_shape)
    device = generator.device if device is None else device
    if cfg.norm == "l2":
        return project_dictionary(
            torch.randn(shape, generator=generator, device=device), "l2")
    return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0


def make_optimizer(params: Iterable[torch.Tensor], lr: float) -> torch.optim.AdamW:
    """AdamW with torch defaults (betas 0.9/0.999, eps 1e-8, wd 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-2)


@dataclasses.dataclass
class TrainState:
    """Learnable attack state, updated in place by the training steps.

    ``d`` is flat ``(K, H*W*C)`` in NHWC pixel order, as JAX's ``AdilState``
    keeps it; :func:`d_image` gives the presentation shape. Each half has
    its AdamW moments and its step count: in ``gd`` mode both halves move
    at every step, so the two counts are the one shared count of JAX's
    joint optimizer; in ``alter`` mode each counts its own phase's steps.
    ``epoch`` counts epochs in ``gd`` mode and alternation rounds in
    ``alter`` mode.
    """

    d: torch.Tensor
    v: torch.Tensor
    d_mu: torch.Tensor
    d_nu: torch.Tensor
    v_mu: torch.Tensor
    v_nu: torch.Tensor
    d_count: int = 0
    v_count: int = 0
    epoch: int = 0


def d_image(d: torch.Tensor, image_shape) -> torch.Tensor:
    """Dictionary in presentation shape (K,)+image_shape from any layout."""
    return d.reshape((d.shape[0],) + tuple(image_shape))


def init_codes(generator: torch.Generator, n_img: int, cfg: AdilConfig,
               mode: str = "gd") -> torch.Tensor:
    """v init per training mode, on the generator's device.

    gd: projected U(0, 1); alter: projected zeros; distributed: projected
    Gaussian.
    """
    shape = (n_img, cfg.n_atoms)
    device = generator.device
    if mode == "alter":
        raw = torch.zeros(shape, device=device)
    elif mode == "distributed":
        raw = torch.randn(shape, generator=generator, device=device)
    else:
        raw = torch.rand(shape, generator=generator, device=device)
    return project_codes(raw, cfg.eps, cfg.norm)


def init_state(generator: torch.Generator, image_shape, n_img: int,
               cfg: AdilConfig, mode: str = "gd",
               d_init: Optional[torch.Tensor] = None) -> TrainState:
    """Fresh training state on the generator's device: D drawn (or a copy of
    ``d_init``), v by :func:`init_codes`, zero moments and counts."""
    device = generator.device
    d = init_dictionary(generator, image_shape, cfg) if d_init is None else d_init
    d = torch.as_tensor(d, dtype=torch.float32, device=device)
    d = d.reshape(d.shape[0], -1).clone()  # a copy: the steps update it in place
    v = init_codes(generator, n_img, cfg, mode).contiguous()
    return TrainState(d=d, v=v, d_mu=torch.zeros_like(d), d_nu=torch.zeros_like(d),
                      v_mu=torch.zeros_like(v), v_nu=torch.zeros_like(v))


def batch_loss(model: Model, d: torch.Tensor, v_rows: torch.Tensor,
               x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               cfg: AdilConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed attack loss over one masked batch, and its fooling count.

    Training applies no pixel clamp on x + Dv (the reference's
    ``Attack_dict_model`` forward). CE carries ``cfg.coeff`` (-1 when
    untargeted); the CW margin handles its sign itself. In bf16 mode dv and
    the sum are bf16, x cast to bf16 where it is not already.
    """
    dt = cfg.compute_dtype
    dv = dict_apply(v_rows, d, dt).reshape(x.shape)
    logits = model((x if dt is None else x.to(dt)) + dv).float()
    if cfg.loss == "ce":
        per = cfg.coeff * F.cross_entropy(logits, labels, reduction="none")
    else:
        per = cw_margin_loss(logits, labels, kappa=cfg.kappa, targeted=cfg.targeted)
    loss = torch.sum(per * mask)
    fooling = torch.sum((torch.argmax(logits, dim=-1) != labels).float() * mask)
    return loss, fooling


def make_train_step(model: Model, cfg: AdilConfig, update: str = "both",
                    reduce_d_grad: Optional[Callable[[torch.Tensor], None]] = None):
    """One projected-AdamW training step over a batch, in place.

    The step takes ``(state, x, labels, idx, mask)``: images, their clean
    labels (see :func:`predict_labels`), global row indices into v, and a
    0/1 mask for padded slots. It updates ``state`` and returns the
    batch's ``(loss, fooling)`` as device scalars. ``update`` is ``"both"``
    (the joint ``gd`` step, lr ``step_size`` for both halves), ``"v"`` or
    ``"d"`` (the ``alter`` phases, lr ``step_size`` for v and
    ``2 * step_size`` for D). The projection follows the AdamW step.

    All of v moves at every step that updates it, as in JAX's optimizer:
    rows outside the batch get a zero gradient, but their moments decay
    and weight decay moves them.

    ``reduce_d_grad``, where given, reduces D's gradient in place before
    D's update: the data-parallel all-reduce (``parallel.adil_dp``).
    """
    if update not in ("both", "v", "d"):
        raise ValueError(f"update must be 'both', 'v' or 'd', got {update!r}")
    train_d = update in ("both", "d")
    train_v = update in ("both", "v")
    lr_d = cfg.step_size if update == "both" else 2 * cfg.step_size
    clip_d = 1.0 if cfg.norm == "linf" else float("inf")

    def step(state: TrainState, x, labels, idx, mask):
        with annotate("adil/step"):
            d = state.d.detach().requires_grad_(train_d)
            v = state.v.detach().requires_grad_(train_v)
            loss, fooling = batch_loss(model, d, v[idx], x, labels, mask, cfg)
            grads = iter(torch.autograd.grad(
                loss, [t for t, on in ((d, train_d), (v, train_v)) if on]))
            with torch.no_grad():
                if train_d:
                    g_d = next(grads)
                    if reduce_d_grad is not None:
                        reduce_d_grad(g_d)
                    state.d_count += 1
                    fused_adamw_project(state.d, g_d, state.d_mu, state.d_nu,
                                        state.d_count, lr_d, clip_d)
                    if cfg.norm == "l2":
                        state.d.copy_(project_dictionary(state.d, "l2"))
                if train_v:
                    state.v_count += 1
                    fused_adamw_project(state.v, next(grads), state.v_mu, state.v_nu,
                                        state.v_count, cfg.step_size, float("inf"))
                    state.v.copy_(project_codes(state.v, cfg.eps, cfg.norm))
            return loss.detach(), fooling

    return step


def make_batches(generator: torch.Generator, n_img: int, batch_size: int) -> torch.Tensor:
    """Shuffled index batches (n_batches, B) on the generator's device,
    padded with -1."""
    perm = torch.randperm(n_img, generator=generator, device=generator.device)
    n_batches = -(-n_img // batch_size)
    pad = n_batches * batch_size - n_img
    perm = torch.cat([perm, perm.new_full((pad,), -1)])
    return perm.reshape(n_batches, batch_size)


def preslice_epoch(images: torch.Tensor, labels: torch.Tensor, batches: torch.Tensor):
    """Per-batch tensors for :func:`run_epoch`: one gather over the dataset
    per epoch. Padded slots (index -1) gather row 0 and are masked out."""
    idx = torch.clamp(batches, min=0)
    return images[idx], labels[idx], batches


def run_epoch(step, state: TrainState, xs, labels_b, idx_b):
    """One epoch of ``step`` over presliced batches (see :func:`preslice_epoch`).

    Returns the epoch's summed ``(loss, fooling)`` as device scalars, with
    no host read, and counts the epoch in ``state.epoch``.
    """
    loss_sum = torch.zeros((), device=state.d.device)
    fool_sum = torch.zeros((), device=state.d.device)
    for x, labels, batch_idx in zip(xs, labels_b, idx_b):
        mask = (batch_idx >= 0).float()
        loss, fooling = step(state, x, labels, torch.clamp(batch_idx, min=0), mask)
        loss_sum += loss
        fool_sum += fooling
    state.epoch += 1
    return loss_sum, fool_sum


def make_train_scan(model: Model, cfg: AdilConfig, update: str = "both",
                    n_steps: int = 10):
    """``n_steps`` chained training steps on one fixed batch.

    The same as calling :func:`make_train_step` ``n_steps`` times on the same
    ``(x, labels, idx, mask)``: the reference's ``steps_in`` repetitions over
    one phase. Returns the per-step losses and fooling counts, stacked on the
    device.
    """
    step = make_train_step(model, cfg, update)

    def run(state: TrainState, x, labels, idx, mask):
        out = [step(state, x, labels, idx, mask) for _ in range(n_steps)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    return run


@torch.no_grad()
def predict_labels(model: Model, images: torch.Tensor, batch_size: int = 256) -> torch.Tensor:
    """Clean-model predictions for a whole dataset, one pass."""
    return torch.cat([torch.argmax(model(images[s:s + batch_size]).float(), dim=-1)
                      for s in range(0, images.shape[0], batch_size)])


def _adamw_loop(x: torch.Tensor, loss_fn, project, lr: float, steps: int,
                tol: float, span: str) -> torch.Tensor:
    """Projected AdamW on ``x`` for at most ``steps`` iterations, stopping
    early once ``max|Δx| < tol``, each iteration a span ``span``. Returns the
    final iterate (detached)."""
    x = x.detach().clone().requires_grad_(True)
    opt = make_optimizer([x], lr)
    for _ in range(steps):
        with annotate(span):
            (x.grad,) = torch.autograd.grad(loss_fn(x), x)
            prev = x.detach().clone()
            opt.step()
            with torch.no_grad():
                x.copy_(project(x))
                delta = torch.max(torch.abs(x - prev))
            with annotate("sync/step_delta"):
                done = delta.item() < tol
        if done:
            break
    return x.detach()


def supervised_ddrague(
    model: Model,
    d: torch.Tensor,
    images: torch.Tensor,
    cfg: AdilConfig,
    eps: Optional[float] = None,
    kappa: Optional[float] = None,
) -> torch.Tensor:
    """Optimize an image-shaped z, reading codes off via the pseudo-inverse.

    AdamW(lr=code_lr) on z for at most ``steps_inference`` iterations, z
    clamped to [-eps, eps] after each step, early stop when max|Δz| < tol.
    Only z is eps-clamped: the returned perturbation D D† z is z's
    projection onto span(D), which can exceed eps in l∞. That is the
    reference's behaviour and is kept. In bf16 mode both in-loop
    contractions and the forward's input are bf16; the final read-off is
    fp32.
    """
    eps = cfg.eps if eps is None else eps
    kappa = cfg.kappa if kappa is None else kappa
    dt = cfg.compute_dtype
    with torch.no_grad(), annotate("adil/ddrague/labels"):
        labels = torch.argmax(model(images).float(), dim=-1)
        with annotate("sync/dict_pinv"):  # the solve checks its result on the host
            d_pinv = dict_pinv(d)
    images_c = images if dt is None else images.to(dt)
    red = "mean" if cfg.loss == "ce" else "sum"

    def loss_fn(z):
        dv = dict_apply(codes_from_pinv(z, d_pinv, dt), d, dt).reshape(images.shape)
        logits = model(images_c + dv).float()
        return attack_loss(logits, labels, loss=cfg.loss, targeted=cfg.targeted,
                           kappa=kappa, reduction=red)

    z = _adamw_loop(torch.zeros_like(images), loss_fn,
                    lambda z: linf_clamp(z, eps), cfg.code_lr,
                    cfg.steps_inference, cfg.tol, "adil/ddrague/step")
    with torch.no_grad(), annotate("adil/readoff"):
        v = codes_from_pinv(z, d_pinv)
        return fused_perturb(v, d, images, float("inf"))


def supervised_adamw_codes(
    model: Model,
    d: torch.Tensor,
    images: torch.Tensor,
    cfg: AdilConfig,
    return_fooling: bool = False,
    eps: Optional[float] = None,
    kappa: Optional[float] = None,
):
    """Optimize fresh codes v for a batch against a frozen dictionary.

    AdamW(lr=code_lr) with the l1/l2-ball projection after each step, at
    most ``steps_code`` iterations, early stop on max|Δv| < tol.
    ``return_fooling=True`` returns the fooling count of the unclipped
    adversaries instead (the training-time validation path). In bf16 mode
    the in-loop contraction and the forward's input are bf16; the returned
    adversaries and the fooling count are computed in fp32.
    """
    eps = cfg.eps if eps is None else eps
    kappa = cfg.kappa if kappa is None else kappa
    dt = cfg.compute_dtype
    with torch.no_grad():
        labels = torch.argmax(model(images).float(), dim=-1)
    images_c = images if dt is None else images.to(dt)
    red = "mean" if cfg.loss == "ce" else "sum"

    def loss_fn(v):
        dv = dict_apply(v, d, dt).reshape(images.shape)
        logits = model(images_c + dv).float()
        return attack_loss(logits, labels, loss=cfg.loss, targeted=cfg.targeted,
                           kappa=kappa, reduction=red)

    v0 = torch.zeros((images.shape[0], cfg.n_atoms), dtype=images.dtype,
                     device=images.device)
    v = _adamw_loop(v0, loss_fn, lambda v: project_codes(v, eps, cfg.norm),
                    cfg.code_lr, cfg.steps_code, cfg.tol, "adil/adamw_codes/step")
    with torch.no_grad(), annotate("adil/readoff"):
        v = project_codes(v, eps, cfg.norm)
        if return_fooling:
            adv = images + dict_apply(v, d).reshape(images.shape)
            adv_labels = torch.argmax(model(adv).float(), dim=-1)
            return torch.sum(adv_labels != labels)
        return fused_perturb(v, d, images, float("inf"))


def sample_sphere(generator: torch.Generator, n: int, cfg: AdilConfig,
                  eps: Optional[float] = None) -> torch.Tensor:
    """Sample codes on the budget sphere, on the generator's device.

    l2: uniform cube direction scaled to the eps l2-sphere; linf: entries
    ~ U(eps, 2 eps) projected onto the eps l1-ball (landing on its surface).
    """
    eps = cfg.eps if eps is None else eps
    u = torch.rand((n, cfg.n_atoms), generator=generator, device=generator.device)
    if cfg.norm == "l2":
        var = u * 2.0 - 1.0
        nrm = torch.linalg.norm(var, dim=1, keepdim=True)
        return eps * var / torch.clamp(nrm, min=1e-12)
    return project_codes(eps + u * eps, eps, cfg.norm)


@torch.no_grad()
def unsupervised_sample(
    model: Model,
    d: torch.Tensor,
    images: torch.Tensor,
    generator: Optional[torch.Generator],
    cfg: AdilConfig,
    eps: Optional[float] = None,
    v_trials: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Best-of-trials random-code attack.

    Per image, across ``trials`` draws: once any draw fools the model, keep
    the minimum-MSE fooling adversary; until then keep the minimum-MSE
    non-fooling one. dv is clamped to ±eps before the pixel clip, inside the
    ``fused_perturb`` kernel. ``v_trials`` ((trials, N, K)) replaces the
    sampler with given codes, and then ``generator`` may be None.
    """
    eps = cfg.eps if eps is None else eps
    with annotate("adil/sample/labels"):
        pre_labels = torch.argmax(model(images).float(), dim=-1)
    n = images.shape[0]
    if v_trials is None:
        with annotate("adil/sample/draws"):
            v_trials = [sample_sphere(generator, n, cfg, eps) for _ in range(cfg.trials)]

    fooled = torch.zeros(n, dtype=torch.bool, device=images.device)
    mse_fool = torch.full((n,), float("inf"), device=images.device)
    mse_nofool = torch.full((n,), float("inf"), device=images.device)
    best = images.clone()
    pixel_axes = tuple(range(1, images.dim()))
    for v in v_trials:
        with annotate("adil/sample/trial"):
            adv = fused_perturb(v.contiguous(), d, images, eps)
            fooling = torch.argmax(model(adv).float(), dim=-1) != pre_labels
            mse = torch.sum((images - adv) ** 2, dim=pixel_axes)

            take_fool = fooling & (mse < mse_fool)
            take_nofool = ~fooled & ~fooling & (mse < mse_nofool)
            mse_fool = torch.where(take_fool, mse, mse_fool)
            mse_nofool = torch.where(take_nofool, mse, mse_nofool)
            take = (take_fool | take_nofool).reshape((n,) + (1,) * (images.dim() - 1))
            best = torch.where(take, adv, best)
            fooled = fooled | fooling
    return best
