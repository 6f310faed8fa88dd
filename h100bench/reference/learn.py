"""Plain joint projected AdamW over (D, v): the ``gd`` dictionary-learning
job, step by step, from the seed.

The draws follow the job's definition: a generator on the images' device
seeded with the job's seed gives D ~ U(-1, 1) of shape (K, H, W, C), then
v ~ U(0, 1) of shape (N, K) projected onto the eps l1 ball, then one
permutation of the N images per epoch, cut into batches (the last padded
with masked slots). Each step: the CW margin summed over the batch at
x + v_rows D (no pixel clip), its gradient in D and in v, one AdamW step on
each (lr ``step_size``; D clamped to ±1, v projected onto the eps l1 ball).
An epoch's loss is its steps' summed loss over N; the job stops early when
an epoch t > 1 moves it by less than ``tol``.
"""

from __future__ import annotations

import torch

from .plain import adamw, cw_margin, l1_ball, labels_of


class Job:
    """The job's draws and state, and its steps: ``step(rows, grad)``
    updates (D, v) from the gradient of the victim's input (N_b, H, W, C)
    for the batch ``rows``."""

    def __init__(self, images: torch.Tensor, seed: int, att: dict, batch: int):
        dev = images.device
        n, k = images.shape[0], att["n_atoms"]
        self.att, self.batch, self.n = att, batch, n
        self.g = torch.Generator(device=dev).manual_seed(seed)
        d0 = torch.rand((k,) + tuple(images.shape[1:]), generator=self.g, device=dev) * 2.0 - 1.0
        self.d0 = d0.reshape(k, -1)
        self.v0 = l1_ball(torch.rand((n, k), generator=self.g, device=dev), att["eps"])
        self.d, self.v = self.d0.clone(), self.v0.clone()
        self.moments = [torch.zeros_like(t) for t in (self.d, self.d, self.v, self.v)]
        self.steps = 0

    def batches(self) -> torch.Tensor:
        """The next epoch's batches of rows, -1 where padded."""
        perm = torch.randperm(self.n, generator=self.g, device=self.d.device)
        n_b = -(-self.n // self.batch)
        return torch.cat([perm, perm.new_full((n_b * self.batch - self.n,), -1)]).reshape(
            n_b, self.batch)

    def perturbation(self, rows: torch.Tensor) -> torch.Tensor:
        return self.v[rows.clamp(min=0)] @ self.d

    def step(self, rows: torch.Tensor, grad: torch.Tensor) -> None:
        rows = rows.clamp(min=0)
        g = grad.reshape(grad.shape[0], -1)
        grad_d = self.v[rows].T @ g
        grad_v = torch.zeros_like(self.v).index_add_(0, rows, g @ self.d.T)
        self.steps += 1
        dm, dn, vm, vn = self.moments
        lr, eps = self.att["step_size"], self.att["eps"]
        self.d, dm, dn = adamw(self.d, grad_d, dm, dn, self.steps, lr, 1.0)
        v, vm, vn = adamw(self.v, grad_v, vm, vn, self.steps, lr)
        self.v = l1_ball(v, eps)
        self.moments = [dm, dn, vm, vn]


def batch_loss(model, x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, kappa: float):
    """The CW margin summed over the batch's real slots, and its gradient
    in the victim's input."""
    x = x.detach().requires_grad_(True)
    loss = torch.sum(cw_margin(model(x), labels, kappa) * mask)
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), grad


def learn(model, images: torch.Tensor, seed: int, att: dict, epochs: int, batch: int) -> dict:
    """D0, v0 (the draws), D, v after the job and the epochs' losses."""
    job = Job(images, seed, att, batch)
    labels = labels_of(model, images)
    losses = []
    for t in range(epochs):
        total = torch.zeros((), device=images.device)
        for rows in job.batches():
            mask = (rows >= 0).to(images.dtype)
            x = images[rows.clamp(min=0)]
            loss, grad = batch_loss(model, x + job.perturbation(rows).reshape(x.shape),
                                    labels[rows.clamp(min=0)], mask, att["kappa"])
            job.step(rows, grad)
            total += loss
        losses.append(float(total) / images.shape[0])
        if t > 1 and abs(losses[-1] - losses[-2]) < att["tol"]:
            break
    return dict(d0=job.d0, v0=job.v0, d=job.d, v=job.v, losses=losses)


def replay(records: list, model, images: torch.Tensor, seed: int, att: dict, batch: int) -> dict:
    """Judge the first steps of a job from the program's own passes.

    ``records`` are the job's first training passes (``harness.Tape``):
    the victim's input, logits and input gradient of each. For each, the
    input has to be the batch's images plus the perturbation that the
    draws and the earlier steps, replayed here from the program's own
    gradients, give (``step_gap``: relative to that perturbation); the
    logits' loss and the gradient have to be the plain victim's at that
    very input (``loss_gap``, ``grad_gap``, relative). ``first_grad_gap``:
    the gradients of D and of v that the first step hands the optimizer,
    from the program's input gradient and from the plain one's at the same
    input, by the worse leaf: the gap between their norms over the plain
    norm of that leaf or of the median leaf, whichever is larger. The last
    record is only read for its input: it shows the state the steps before
    it left.
    """
    job = Job(images, seed, att, batch)
    labels = labels_of(model, images)
    out = {"loss_gap": 0.0, "grad_gap": 0.0, "step_gap": 0.0}
    rows_of = job.batches()
    while len(rows_of) < len(records):  # the first steps may reach into the next epoch
        rows_of = torch.cat([rows_of, job.batches()])
    for t, rec in enumerate(records):
        rows = rows_of[t]
        x = images[rows.clamp(min=0)]
        dv = job.perturbation(rows).reshape(x.shape)
        out["step_gap"] = max(out["step_gap"], float(torch.linalg.vector_norm(rec["x"] - x - dv)
                                                     / torch.linalg.vector_norm(dv)))
        if t == len(records) - 1:
            break
        mask = (rows >= 0).to(images.dtype)
        lab = labels[rows.clamp(min=0)]
        loss, grad = batch_loss(model, rec["x"], lab, mask, att["kappa"])
        got = torch.sum(cw_margin(rec["logits"], lab, att["kappa"]) * mask)
        out["loss_gap"] = max(out["loss_gap"], float(abs(got - loss) / abs(loss)))
        out["grad_gap"] = max(out["grad_gap"], float(torch.linalg.vector_norm(rec["grad"] - grad)
                                                     / torch.linalg.vector_norm(grad)))
        if t == 0:
            out["first_grad_gap"] = first_grad_gap(job, rows, rec["grad"], grad)
        with torch.no_grad():
            job.step(rows, rec["grad"])
    return out


def first_grad_gap(job: Job, rows: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> float:
    """The worse leaf's gap between the norms of the step's gradients of D
    and v from the input gradients ``got`` and ``want``."""
    rows = rows.clamp(min=0)

    def leaves(grad):
        g = grad.reshape(grad.shape[0], -1)
        return [float(torch.linalg.vector_norm(job.v[rows].T @ g)),
                float(torch.linalg.vector_norm(g @ job.d.T))]

    p, r = leaves(got), leaves(want)
    median = sorted(r)[len(r) // 2] if len(r) % 2 else sum(r) / len(r)
    return max(abs(a - b) / max(b, median) for a, b in zip(p, r))
