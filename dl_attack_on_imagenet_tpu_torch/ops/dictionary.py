"""Dictionary contraction math: D·v as matrix products.

Port of ``dl_attack_on_imagenet_tpu/ops/dictionary.py``. The dictionary is
stored atoms-first, ``(K, H, W, C)`` or flat ``(K, M)`` with M = H*W*C in
NHWC pixel order, so each contraction is one ``(N, K) @ (K, M)`` product.

By default these products run in true fp32: reduced precision (bf16 passes
on the TPU, TF32 on Hopper) lets the computed ``||Dv||_inf`` exceed the eps
budget by about 1e-4. ``torch.matmul`` is true fp32 on the card while
``torch.backends.cuda.matmul.allow_tf32`` is False, which is torch's
default; the fp32 path raises on a CUDA tensor when that flag is on, rather
than run in TF32.

With ``compute_dtype=torch.bfloat16`` (the mixed-precision inner forwards
only) both operands are rounded to bf16 and the product is returned in
bf16. XLA computes such a product with an fp32 accumulator and rounds once
at the end; the port does the same. cuBLAS may instead reduce split-K
partial sums in bf16 while
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
True (torch's default), which for ``codes_from_pinv`` (150528 terms a
code at 224²) adds a rounding per partial sum. So the bf16 path raises on a
CUDA tensor while that flag is on: the CLIs turn it off
(``cli._victim.set_precision``), and a library caller sets it to False.
"""

from __future__ import annotations

from typing import Optional

import torch


def require_full_fp32(t: torch.Tensor) -> None:
    """Raise if an fp32 matmul on ``t`` would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "dictionary contractions need true fp32, but "
            "torch.backends.cuda.matmul.allow_tf32 is True")


def require_fp32_accumulation(t: torch.Tensor) -> None:
    """Raise if a bf16 matmul on ``t`` could reduce partial sums in bf16."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "bf16 dictionary contractions accumulate in fp32 and round once, as XLA "
            "does, but torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction "
            "is True; set it to False")


def _operands(a: torch.Tensor, b: torch.Tensor, compute_dtype: Optional[torch.dtype]):
    """``a`` and ``b`` cast to ``compute_dtype`` where one is given, after
    the check that its products run as the module says."""
    if compute_dtype is None:
        require_full_fp32(a)
        return a, b
    require_fp32_accumulation(a)
    return a.to(compute_dtype), b.to(compute_dtype)


def dict_flatten(d: torch.Tensor) -> torch.Tensor:
    """(K, H, W, C) -> (K, M)."""
    return d.reshape(d.shape[0], -1)


def dict_apply(v: torch.Tensor, d: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Perturbations ``dv`` for a batch of codes.

    Args:
      v: (N, K) coding vectors.
      d: dictionary, either (K, H, W, C) or flat (K, M).
      compute_dtype: None runs the product in true fp32 (wherever dv feeds
        an eps-budget guarantee); ``torch.bfloat16`` runs it in bf16 with an
        fp32 accumulator, for the mixed-precision inner forwards only.

    Returns:
      (N, H, W, C) (or (N, M) if d was flat) perturbations, in
      ``compute_dtype`` where one is given.
    """
    v, d_flat = _operands(v, dict_flatten(d), compute_dtype)
    out = v @ d_flat
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


def codes_from_pinv(z: torch.Tensor, d_pinv: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """v = z · D†ᵀ for image-shaped z (N, H, W, C) (or flat (N, M)).

    ``compute_dtype`` follows :func:`dict_apply`: None is true fp32, a dtype
    rounds both operands to it and returns the codes in it (DDrague's
    mixed-precision in-loop read-off).
    """
    z, d_pinv = _operands(z.reshape(z.shape[0], -1), d_pinv, compute_dtype)
    return z @ d_pinv.T
