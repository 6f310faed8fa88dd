"""Faults planted in the program's timed path, for the check to catch.

``unchanged``: training steps, and the solvers' AdamW, leave the state as
it is. ``half_batch``: the loss of half of the batch, the mean taken over
that half. ``altered``: the first image's adversary replaced by its clean
image where the adversaries are produced. The CPU rehearsal plants them
at a tiny size, ``calibrate.py --fault`` at a cell's own size on the card.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from .program import adil_core


def _unchanged() -> dict:
    class Still(torch.optim.AdamW):
        def step(self, closure=None):
            return None

    return {"fused_adamw_project": lambda p, g, mu, nu, *a, **k: (p, mu, nu),
            "make_optimizer": lambda params, lr: Still(params, lr=lr)}


def _half_batch() -> dict:
    batch_loss, attack_loss = adil_core.batch_loss, adil_core.attack_loss

    def half_mask(model, d, v_rows, x, labels, mask, cfg):
        kept = mask.clone()
        kept[len(kept) // 2:] = 0
        loss, fooling = batch_loss(model, d, v_rows, x, labels, kept, cfg)
        return 2 * loss, fooling

    def half_loss(logits, labels, **kw):
        h = len(logits) // 2
        return 2 * attack_loss(logits[:h], labels[:h], **kw)

    return {"batch_loss": half_mask, "attack_loss": half_loss}


def _altered() -> dict:
    fused_perturb = adil_core.fused_perturb

    def altered(v, d, x, eps):
        out = fused_perturb(v, d, x, eps)
        out[0] = x[0]
        return out

    return {"fused_perturb": altered}


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` in place, for the ``with``
    block's length."""
    with contextlib.ExitStack() as stack:
        for attr, value in FAULTS[name]().items():
            stack.enter_context(mock.patch.object(adil_core, attr, value))
        yield
