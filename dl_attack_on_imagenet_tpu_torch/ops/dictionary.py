"""Dictionary contraction math: D·v as fp32 matrix products.

Port of ``dl_attack_on_imagenet_tpu/ops/dictionary.py``. The dictionary is
stored atoms-first, ``(K, H, W, C)`` or flat ``(K, M)`` with M = H*W*C in
NHWC pixel order, so each contraction is one ``(N, K) @ (K, M)`` product.

These products must run in true fp32: reduced precision (bf16 passes on the
TPU, TF32 on Hopper) lets the computed ``||Dv||_inf`` exceed the eps budget
by about 1e-4. ``torch.matmul`` is true fp32 on the card while
``torch.backends.cuda.matmul.allow_tf32`` is False, which is torch's
default; every function here raises on a CUDA tensor when that flag is on,
rather than run in TF32.
"""

from __future__ import annotations

import torch


def require_full_fp32(t: torch.Tensor) -> None:
    """Raise if a matmul on ``t`` would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "dictionary contractions need true fp32, but "
            "torch.backends.cuda.matmul.allow_tf32 is True")


def dict_flatten(d: torch.Tensor) -> torch.Tensor:
    """(K, H, W, C) -> (K, M)."""
    return d.reshape(d.shape[0], -1)


def dict_apply(v: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Perturbations ``dv`` for a batch of codes.

    Args:
      v: (N, K) coding vectors.
      d: dictionary, either (K, H, W, C) or flat (K, M).

    Returns:
      (N, H, W, C) (or (N, M) if d was flat) perturbations.
    """
    require_full_fp32(v)
    out = v @ dict_flatten(d)
    return out.reshape((v.shape[0],) + tuple(d.shape[1:]))


def dict_gram(d: torch.Tensor) -> torch.Tensor:
    """Gram matrix D Dᵀ of shape (K, K) over flattened atoms."""
    require_full_fp32(d)
    d_flat = dict_flatten(d)
    return d_flat @ d_flat.T


def dict_pinv(d: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """Pseudo-inverse contraction operator D† = (D Dᵀ)⁻¹ D of shape (K, M).

    ``codes_from_pinv(z, d_pinv)`` then maps an image-shaped perturbation z
    to the least-squares codes. ``ridge`` adds a Tikhonov term for
    near-rank-deficient dictionaries.
    """
    d_flat = dict_flatten(d)
    gram = dict_gram(d_flat)
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    if ridge:
        gram = gram + ridge * eye
    # Solve the small (K, K) system against the identity, then one product.
    gram_inv = torch.linalg.solve(gram, eye)
    return gram_inv @ d_flat


def codes_from_pinv(z: torch.Tensor, d_pinv: torch.Tensor) -> torch.Tensor:
    """v = z · D†ᵀ for image-shaped z (N, H, W, C) (or flat (N, M))."""
    require_full_fp32(z)
    return z.reshape(z.shape[0], -1) @ d_pinv.T
