"""Plain supervised DDrague: AdamW on an image-shaped z, its codes read
off through the pseudo-inverse of D.

Labels are the clean model's top-1. Each step: codes = z D†ᵀ, the CW margin
summed over the batch at x + codes D, its gradient in z, one AdamW step (lr
``code_lr``), z clamped to ±eps; the loop stops after ``steps`` or once no
entry of z moved by ``tol`` or more. The adversary is clip(x + (z D†ᵀ) D,
0, 1), with no clamp of the perturbation (z is clamped, its projection on
the span of D is not).
"""

from __future__ import annotations

import torch

from .plain import adamw, cw_margin, pinv_rows


def ddrague(model, d: torch.Tensor, images: torch.Tensor, att: dict, steps: int) -> torch.Tensor:
    """The adversaries of ``images``."""
    k, n = d.shape[0], images.shape[0]
    d_flat = d.reshape(k, -1)
    with torch.no_grad():
        labels = model(images).argmax(dim=-1)
    pinv = pinv_rows(d_flat)
    z = torch.zeros((n, d_flat.shape[1]), device=images.device)
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    for step in range(1, steps + 1):
        zg = z.requires_grad_(True)
        logits = model(images + ((zg @ pinv.T) @ d_flat).reshape(images.shape))
        (grad,) = torch.autograd.grad(torch.sum(cw_margin(logits, labels, att["kappa"])), zg)
        with torch.no_grad():
            new, mu, nu = adamw(z.detach(), grad, mu, nu, step, att["code_lr"])
            new = torch.clamp(new, -att["eps"], att["eps"])
            moved = float(torch.max(torch.abs(new - z)))
        z = new
        if moved < att["tol"]:
            break
    with torch.no_grad():
        return torch.clamp(images + ((z @ pinv.T) @ d_flat).reshape(images.shape), 0.0, 1.0)


def pass_gaps(rec: dict, model, labels: torch.Tensor, att: dict) -> tuple:
    """A recorded step pass's logits and input gradient against the plain
    victim's at the very same input: (max gap over max logit, relative l2)."""
    xg = rec["x"].detach().requires_grad_(True)
    logits = model(xg)
    (grad,) = torch.autograd.grad(torch.sum(cw_margin(logits, labels, att["kappa"])), xg)
    logits = logits.detach()
    return (float((rec["logits"] - logits).abs().max() / logits.abs().max()),
            float(torch.linalg.vector_norm(rec["grad"] - grad) / torch.linalg.vector_norm(grad)))


def _floor(images: torch.Tensor, att: dict) -> float:
    """The scale a step's input is judged on where the perturbation is 0
    (the first step's)."""
    return att["eps"] * float(images[0].numel()) ** 0.5 * 1e-3


def first_step(rec: dict, model, images: torch.Tensor, att: dict) -> dict:
    """Judge a batch's first DDrague step from its recorded pass: z starts
    at 0, so its input has to be the images themselves (``solver_gap``,
    relative to the floor of :func:`replay`), and its logits and input
    gradient the plain victim's there (``logit_gap``, ``grad_gap``)."""
    with torch.no_grad():
        labels = model(images).argmax(dim=-1)
    logit_gap, grad_gap = pass_gaps(rec, model, labels, att)
    solver_gap = float(torch.linalg.vector_norm(rec["x"] - images)) / _floor(images, att)
    return {"logit_gap": logit_gap, "grad_gap": grad_gap, "solver_gap": solver_gap}


def replay(records: list, model, d: torch.Tensor, images: torch.Tensor, adv: torch.Tensor,
           att: dict, steps: int) -> dict:
    """Judge one DDrague batch from the program's own passes.

    ``records`` are every pass of the batch (``harness.Tape``): the label
    pass on the clean images, then one per step with its input gradient.
    ``logit_gap``, ``grad_gap``: the program's logits and input gradients
    against the plain victim's at the very same inputs (relative, the
    worst pass). ``solver_gap``: each step's input, and then the returned
    adversary ``adv``, against what the plain solver gives when it is
    driven by the program's own gradients (relative to the perturbation).
    A run of another number of steps than the replay's reads inf.
    """
    k = d.shape[0]
    d_flat = d.reshape(k, -1)
    pinv = pinv_rows(d_flat)
    with torch.no_grad():
        clean = model(images)
    labels = clean.argmax(dim=-1)
    out = {"logit_gap": float((records[0]["logits"] - clean).abs().max() / clean.abs().max()),
           "grad_gap": 0.0, "solver_gap": 0.0}
    floor = _floor(images, att)  # the first step's dv is 0

    def gap(got, want):
        return float(torch.linalg.vector_norm(got - want)
                     / max(float(torch.linalg.vector_norm(want - images)), floor))

    z = torch.zeros((images.shape[0], d_flat.shape[1]), device=images.device)
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    ran, stopped = 0, False
    for step, rec in enumerate(records[1:], 1):
        with torch.no_grad():
            x = images + ((z @ pinv.T) @ d_flat).reshape(images.shape)
        out["solver_gap"] = max(out["solver_gap"], gap(rec["x"], x))
        logit_gap, grad_gap = pass_gaps(rec, model, labels, att)
        out["logit_gap"] = max(out["logit_gap"], logit_gap)
        out["grad_gap"] = max(out["grad_gap"], grad_gap)
        with torch.no_grad():
            gz = (rec["grad"].reshape(z.shape) @ d_flat.T) @ pinv
            new, mu, nu = adamw(z, gz, mu, nu, step, att["code_lr"])
            new = torch.clamp(new, -att["eps"], att["eps"])
            moved = float(torch.max(torch.abs(new - z)))
        z, ran = new, step
        if moved < att["tol"]:
            stopped = True
            break
    if ran != len(records) - 1 or not (stopped or ran == steps):
        out["solver_gap"] = float("inf")
        return out
    with torch.no_grad():
        want = torch.clamp(images + ((z @ pinv.T) @ d_flat).reshape(images.shape), 0.0, 1.0)
    out["solver_gap"] = max(out["solver_gap"], gap(adv, want))
    return out
