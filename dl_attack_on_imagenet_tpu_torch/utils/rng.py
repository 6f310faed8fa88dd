"""Small RNG helpers.

Port of ``dl_attack_on_imagenet_tpu/utils/rng.py``: where JAX splits a key
into a fresh subkey per draw, the port hands out fresh, explicitly seeded
``torch.Generator``s split from one seed.
"""

from __future__ import annotations

from typing import Iterator

import torch

from .. import DeviceLike, resolve_device


def key_seq(seed: int, device: DeviceLike = None) -> Iterator[torch.Generator]:
    """Endless sequence of fresh generators on ``device``, each seeded from
    a host generator seeded with ``seed``: the same seed gives the same
    sequence on any device. ``device`` defaults to CUDA and raises where
    there is none."""
    device = resolve_device(device)
    parent = torch.Generator().manual_seed(seed)
    while True:
        sub = int(torch.randint(0, 2**62, (), generator=parent))
        yield torch.Generator(device=device).manual_seed(sub)
