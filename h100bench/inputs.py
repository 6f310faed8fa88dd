"""Everything a run makes from ``--seed``: sub-seeds, the victim's weights
and the images. Both the program and the plain reference get these same
tensors."""

from __future__ import annotations

import hashlib
import importlib

import torch
import torch.nn.functional as F


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    """A seed for one purpose, derived from the run's seed and a tag."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - bits)


def architecture(config: dict):
    """The reference module of the configuration's architecture."""
    return importlib.import_module(f"h100bench.reference.{config['architecture']}")


def weights(config: dict, seed: int, device) -> dict:
    """The victim's parameters by torchvision's names, drawn on ``device``
    in one ``randn`` call and scaled per tensor (the configuration's
    ``weights`` section and its reference's ``param_specs`` say how)."""
    specs = architecture(config).param_specs(config)
    sizes = [torch.Size(shape).numel() for _, shape, (kind, _) in specs if kind == "normal"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    params, at = {}, 0
    for name, shape, (kind, value) in specs:
        if kind == "normal":
            n = torch.Size(shape).numel()
            params[name] = flat[at:at + n].reshape(shape) * value
            at += n
        else:
            params[name] = torch.full(shape, float(value), device=device)
    return params


def images(seed: int, tag: str, n: int, size: int, device, chunk: int = 250) -> torch.Tensor:
    """``n`` NHWC images in [0, 1]: a random 8x8 colour field, bilinearly
    upsampled, plus 15% of pixel noise, made in chunks on ``device``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, f"images:{tag}"))
    out = torch.empty((n, size, size, 3), device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        low = torch.rand((m, 3, 8, 8), generator=g, device=device)
        noise = torch.rand((m, 3, size, size), generator=g, device=device)
        smooth = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
        out[s:s + m] = torch.clamp(0.85 * smooth + 0.15 * noise, 0.0, 1.0).permute(0, 2, 3, 1)
    return out


def dictionary(seed: int, n_atoms: int, size: int, device) -> torch.Tensor:
    """A dictionary (K, H, W, C) drawn U(-1, 1): inside the l∞ attack's
    constraint set |D| <= 1 as drawn, so its projection leaves it as it is."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "dictionary"))
    return torch.rand((n_atoms, size, size, 3), generator=g, device=device) * 2.0 - 1.0
