"""UAP-PGD: universal adversarial perturbation by clipped-CE PGD.

Port of ``dl_attack_on_imagenet_tpu/attacks/uap_pgd.py``: one shared
perturbation ``e`` of shape ``(1, H, W, C)``, trained with Adam or SGD on
the clipped negative cross-entropy against the TRUE labels, and projected
onto its eps ball after every step. ``torch.optim.Adam`` and ``SGD`` stand
for ``optax.adam`` and ``sgd``: the same rule, ``lr * m_hat / (sqrt(v_hat)
+ 1e-8)`` for Adam and ``lr * g`` for SGD, with no decoupled decay (so not
the ``fused_adamw_project`` kernel, which decays and clamps).

The data-parallel epoch (``UAPPGD(mesh=...)``) is JAX's ``shard_map`` with
``pmean``: each rank runs its own local plan over its rows, ``e``'s
gradient is all-reduced and divided by the world size each step (DDP's
averaging), and the loss (averaged) and fooling count (summed) are
all-reduced once an epoch. Only ``all_reduce`` on device tensors, so one
code path runs over NCCL and gloo. :func:`make_uap_dp_replay_epoch_fn` is
its serial replay over the union batches.

The epoch's losses stay on the device; they are read once, after the
last epoch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data import as_array_dataset
from ..models import VictimModel
from ..ops import clamp_image, l2_ball_project, linf_clamp
from ..utils import ArtifactCache
from .adil_core import make_batches
from .base import Attack


def project_uap(e: torch.Tensor, eps: float, norm: str) -> torch.Tensor:
    """Project the universal perturbation onto its budget ball (a no-op at
    eps = inf in both norms)."""
    if norm == "l2":
        return l2_ball_project(e, eps, axis=None)
    return linf_clamp(e, eps)


@torch.no_grad()
def fold_increments(attack: torch.Tensor, deltas: torch.Tensor, accept: torch.Tensor,
                    eps: float, norm: str) -> torch.Tensor:
    """Fold the accepted per-image increments into the universal
    perturbation in row order, projecting after every fold: ``a =
    project_uap(a + accept_i * deltas_i)``, the per-image accumulation of
    Fast-UAP and ``universal_perturbation``."""
    weights = accept.to(attack.dtype)
    for d, m in zip(deltas, weights):
        attack = project_uap(attack + m * d, eps, norm)
    return attack


def uap_loss(model, e: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             beta: float):
    """Clipped negative CE, ``max(-ce, -beta)`` with ce the mean over the
    real rows (``mask``), and the batch's fooling count against the true
    labels ``y``."""
    logits = model(x + e).float()
    nll = F.cross_entropy(logits, y, reduction="none")
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.clamp(-ce, min=-beta)
    fooling = torch.sum((torch.argmax(logits, -1) != y).float() * mask)
    return loss, fooling


def make_optimizer(params, optimizer: str, step_size: float) -> torch.optim.Optimizer:
    """``sgd`` is plain SGD; anything else is Adam (betas 0.9/0.999, eps
    1e-8), as the JAX package dispatches."""
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=step_size)
    return torch.optim.Adam(params, lr=step_size, betas=(0.9, 0.999), eps=1e-8)


def _apply(cfg, e, opt, grad) -> None:
    """The optimizer step on ``e`` with ``grad``, then the projection,
    in place."""
    e.grad = grad
    opt.step()
    with torch.no_grad():
        e.copy_(project_uap(e, cfg.eps, cfg.norm))


def _step(model, cfg, e, opt, x, y, batch_idx, group=None):
    """One projected optimizer step on ``e`` in place; returns the batch's
    (loss, fooling) as device scalars. With ``group`` the gradient is
    averaged over its ranks first."""
    loss, fooling = uap_loss(model, e, x, y, (batch_idx >= 0).float(), cfg.beta)
    (grad,) = torch.autograd.grad(loss, e)
    if group is not None:
        dist.all_reduce(grad, group=group)
        grad /= dist.get_world_size(group)
    _apply(cfg, e, opt, grad)
    return loss.detach(), fooling


def make_uap_epoch_fn(model, cfg: "UAPPGD", mesh=None, axis: str = "data"):
    """One epoch over resident (images, labels), gathering each batch of
    the plan: ``epoch(e, opt, images, labels, batches) -> (loss_sum,
    fooling_sum)``, with ``e`` (a leaf that requires grad) and ``opt``
    updated in place and the sums on the device.

    ``batches`` is ``(n_batches, B)`` row indices, -1 for padding (padded
    slots gather row 0 and are masked out). With ``mesh`` the images and
    labels are this rank's rows, ``batches`` is this rank's local plan, the
    gradient is averaged over the ranks each step and the sums are global
    (the loss averaged, the fooling count summed).
    """
    group = mesh.get_group(axis) if mesh is not None else None

    def epoch_fn(e, opt, images, labels, batches):
        loss_sum = torch.zeros((), device=e.device)
        fool_sum = torch.zeros((), device=e.device)
        for batch_idx in batches:
            idx = torch.clamp(batch_idx, min=0)
            loss, fooling = _step(model, cfg, e, opt, images[idx], labels[idx], batch_idx, group)
            loss_sum += loss
            fool_sum += fooling
        if group is not None:
            sums = torch.stack([loss_sum, fool_sum])
            dist.all_reduce(sums, group=group)
            loss_sum, fool_sum = sums[0] / dist.get_world_size(group), sums[1]
        return loss_sum, fool_sum

    return epoch_fn


def make_uap_epoch_fn_presliced(model, cfg: "UAPPGD"):
    """Serial epoch over pre-sliced batches (``adil_core.preslice_epoch``):
    ``epoch(e, opt, xs, ys, idx_b) -> (loss_sum, fooling_sum)``, the same
    steps as :func:`make_uap_epoch_fn` on the same batches.

    ``UAPPGD`` learns through the gather epoch; this one stays as the
    counterpart of the JAX package's ``make_uap_epoch_fn_presliced``, for
    callers that hold their batches pre-sliced."""

    def epoch_fn(e, opt, xs, ys, idx_b):
        loss_sum = torch.zeros((), device=e.device)
        fool_sum = torch.zeros((), device=e.device)
        for x, y, batch_idx in zip(xs, ys, idx_b):
            loss, fooling = _step(model, cfg, e, opt, x, y, batch_idx)
            loss_sum += loss
            fool_sum += fooling
        return loss_sum, fool_sum

    return epoch_fn


def make_uap_dp_replay_epoch_fn(model, cfg: "UAPPGD", n_dev: int):
    """One-process replay of the data-parallel epoch on the union batches.

    ``epoch(e, opt, images, labels, batches) -> (loss_sum, fooling_sum)``
    with the whole set padded as ``parallel.adil_dp.shard_rows`` pads it
    and ``batches`` of shape (n_batches, n_dev * B_local)
    (``global_batches_from_local``). Each step splits its batch into the
    ranks' ``n_dev`` parts, clips each part's CE on its own and averages
    the clipped losses, so its gradient is the DP step's averaged
    all-reduce.
    """

    def epoch_fn(e, opt, images, labels, batches):
        loss_sum = torch.zeros((), device=e.device)
        fool_sum = torch.zeros((), device=e.device)
        for batch_idx in batches:
            idx = torch.clamp(batch_idx, min=0)
            parts = [uap_loss(model, e, images[i], labels[i], (b >= 0).float(), cfg.beta)
                     for i, b in zip(idx.chunk(n_dev), batch_idx.chunk(n_dev))]
            loss = torch.stack([p[0] for p in parts]).mean()
            (grad,) = torch.autograd.grad(loss, e)
            _apply(cfg, e, opt, grad)
            loss_sum += loss.detach()
            fool_sum += sum(p[1] for p in parts)
        return loss_sum, fool_sum

    return epoch_fn


@torch.no_grad()
def additive_fooling_rate(model, e: torch.Tensor, images: torch.Tensor,
                          batch_size: int = 128) -> float:
    """Share of ``images`` whose prediction changes under ``x + e``, in
    batches of ``batch_size``; the count is summed on the device and read
    once."""
    n = images.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=images.device)
    for s in range(0, n, batch_size):
        x = images[s:s + batch_size]
        clean = torch.argmax(model(x).float(), -1)
        pert = torch.argmax(model(x + e).float(), -1)
        total += torch.sum(clean != pert)
    return int(total) / n


class UAPPGD(Attack):
    """Universal perturbation by clipped-CE PGD.

    The constructor learns ``e`` on ``data_train`` unless the artifact
    ``UAPPGD_model_<name>`` is in ``cache`` (payload ``{"e": (1, H, W, C),
    "fooling_rate": f32[epochs with val]}``, the JAX package's bytes);
    ``forward`` learns on its batch where there is neither. Each epoch's
    plan of batches comes from a host ``torch.Generator`` seeded with
    ``seed``, so the card and the CPU follow one plan. With ``mesh`` (a
    ``parallel.data_mesh``) learning is data-parallel and only rank 0
    writes the artifact.
    """

    def __init__(
        self,
        victim: VictimModel,
        data_train=None,
        data_val=None,
        steps: int = 10,
        batch_size: int = 100,
        beta: float = 9.0,
        step_size: float = 0.01,
        norm: str = "l2",
        eps: float = 0.1,
        optimizer: str = "adam",
        mesh=None,
        model_name: Optional[str] = None,
        cache: Optional[ArtifactCache] = None,
        seed: int = 0,
        verbose: bool = False,
    ):
        super().__init__(victim, "UAPPGD", targeted=False)
        self.beta = beta
        self.steps = int(steps)
        self.step_size = step_size
        self.batch_size = batch_size
        self.norm = norm.lower()
        self.eps = eps
        self.optimizer = optimizer.lower()
        self.mesh = mesh
        self.model_name = model_name or victim.name
        self.cache = cache or ArtifactCache("trained_dicts")
        self.seed = seed
        self.verbose = verbose
        self.attack_vec: Optional[torch.Tensor] = None
        self.history: dict = {}

        if not self.cache.exists("UAPPGD", model=self.model_name) and data_train is not None:
            self.learn_attack(data_train, data_val)

    @property
    def is_trained(self) -> bool:
        """Whether ``forward`` would skip its lazy learn."""
        return self.attack_vec is not None or self.cache.exists("UAPPGD", model=self.model_name)

    @property
    def device(self) -> torch.device:
        return self.victim.device

    def make_optimizer(self, params) -> torch.optim.Optimizer:
        return make_optimizer(params, self.optimizer, self.step_size)

    def _resident(self, ds):
        """Images and labels on the device (this rank's rows with a mesh)
        and a function that draws the next epoch's plan for them."""
        dev, n = self.device, len(ds)
        plans = torch.Generator().manual_seed(self.seed)
        images = np.asarray(ds.images, np.float32)
        labels = np.asarray(ds.labels, np.int64)
        if self.mesh is None:
            return (torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev),
                    lambda: make_batches(plans, n, self.batch_size).to(dev))
        from ..parallel.adil_dp import make_local_batches, shard_rows

        rank = dist.get_rank(self.mesh.get_group("data"))
        n_dev = self.mesh.size()
        return (shard_rows(self.mesh, images, device=dev), shard_rows(self.mesh, labels, device=dev),
                lambda: torch.as_tensor(make_local_batches(plans, n, n_dev, self.batch_size)[rank],
                                        device=dev))

    def learn_attack(self, data_train, data_val=None) -> None:
        """Learn ``e`` over ``steps`` epochs, save the artifact and keep
        ``e``; with ``data_val``, the val fooling rate after each epoch."""
        ds = as_array_dataset(data_train)
        images, labels, next_plan = self._resident(ds)
        e = torch.zeros((1,) + ds.image_shape, device=self.device, requires_grad=True)
        opt = self.make_optimizer([e])
        epoch_fn = make_uap_epoch_fn(self.victim, self, self.mesh)
        val_images = None
        if data_val is not None:
            val_images = torch.as_tensor(as_array_dataset(data_val).images, dtype=torch.float32,
                                         device=self.device)
        losses, fooling_rate = [], []
        for it in range(self.steps):
            loss, fooling = epoch_fn(e, opt, images, labels, next_plan())
            losses.append(loss)
            if val_images is not None:
                fooling_rate.append(additive_fooling_rate(self.victim, e, val_images))
            if self.verbose:
                print(f"[uappgd] epoch {it} train_fool {float(fooling) / len(ds):.3f} "
                      f"val_fool {fooling_rate[-1] if fooling_rate else None}")
        self.attack_vec = e.detach()
        self.history = {"loss": torch.stack(losses).tolist() if losses else [],
                        "fooling_rate": fooling_rate}
        if self.mesh is None or dist.get_rank() == 0:
            self.cache.save({"e": self.attack_vec,
                             "fooling_rate": np.asarray(fooling_rate, np.float32)},
                            "UAPPGD", model=self.model_name)

    def _load(self) -> torch.Tensor:
        if self.attack_vec is None:
            payload = self.cache.load("UAPPGD", model=self.model_name)
            if payload is None:
                raise FileNotFoundError("UAP-PGD attack has not been learned")
            self.attack_vec = torch.as_tensor(payload["e"], dtype=torch.float32,
                                              device=self.device)
        return self.attack_vec

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not self.is_trained:
            self.learn_attack((images.detach().cpu().numpy(), labels.detach().cpu().numpy()),
                              None)
        return clamp_image(images + self._load())
