"""Hand-written CUDA kernels of the port, each beside its plain torch twin.

``fused_perturb`` replaces the Pallas TPU kernel of the same name in
``dl_attack_on_imagenet_tpu/ops/pallas_kernels.py``; its CUDA source is
``csrc/fused_perturb.cu``. On a CUDA tensor the wrapper launches the kernel
or raises; only tensors on the CPU take the plain twin.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .dictionary import require_full_fp32


def fused_perturb_reference(v, d_flat, x_flat, eps, lo=0.0, hi=1.0):
    """Plain form: ``clip(x + clamp(v @ D, -eps, eps), lo, hi)`` on (N, M)."""
    require_full_fp32(v)
    dv = v @ d_flat
    return torch.clamp(x_flat + torch.clamp(dv, -eps, eps), lo, hi)


def _bind(lib: ctypes.CDLL):
    fn = lib.fused_perturb_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_perturb_max_k.argtypes = []
    lib.fused_perturb_max_k.restype = ctypes.c_int
    return fn, lib.fused_perturb_max_k()


# The kernel tiles pixel columns 512 at a time along gridDim.y (at most 65535).
_MAX_M = 65535 * 512


def fused_perturb(v: torch.Tensor, d: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """adv = clip(x + clamp(v @ D, -eps, eps), 0, 1), fused.

    Args:
      v: (N, K) codes. d: (K, H, W, C) or (K, M) dictionary, NHWC pixel order.
      x: (N, H, W, C) or (N, M) images; the output has x's shape.
      eps: l∞ clamp of the perturbation; ``float('inf')`` for none.

    On CUDA every input must be contiguous float32 on one device. Each
    launch adds one to ``fused_perturb.launches``.
    """
    if v.dim() != 2:
        raise ValueError(f"v must be (N, K), got {tuple(v.shape)}")
    n, k = v.shape
    if d.shape[0] != k:
        raise ValueError(f"d has {d.shape[0]} atoms, v has {k} codes")
    m = d[0].numel()
    if x.shape[0] != n or x[0].numel() != m:
        raise ValueError(f"x {tuple(x.shape)} does not match v {tuple(v.shape)} "
                         f"and d {tuple(d.shape)}")
    tensors = (v, d, x)
    if all(t.device.type == "cpu" for t in tensors):
        out = fused_perturb_reference(v, d.reshape(k, m), x.reshape(n, m), eps)
        return out.reshape(x.shape)
    if not all(t.is_cuda and t.device == v.device for t in tensors):
        raise ValueError("fused_perturb: v, d and x must all be on one CUDA "
                         "device (or all on the CPU)")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("fused_perturb: the kernel takes float32 only")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_perturb: the kernel takes contiguous tensors only")
    fn, max_k = _bind(native.load("fused_perturb"))
    if not 0 < k <= max_k:
        raise ValueError(f"fused_perturb: the kernel takes 1..{max_k} atoms, got {k}")
    if not 0 < m <= _MAX_M:
        raise ValueError(f"fused_perturb: the kernel takes 1..{_MAX_M} pixels, got {m}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = fn(v.data_ptr(), d.data_ptr(), x.data_ptr(), out.data_ptr(),
             n, k, m, float(eps), stream)
    if err:
        raise RuntimeError(f"fused_perturb: kernel launch failed with CUDA "
                           f"error {err}")
    fused_perturb.launches += 1
    return out


fused_perturb.launches = 0
