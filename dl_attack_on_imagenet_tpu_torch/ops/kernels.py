"""Hand-written CUDA kernels of the port, each beside its plain torch twin.

``fused_perturb`` and ``fused_adamw_project`` replace the Pallas TPU kernels
of the same names in ``dl_attack_on_imagenet_tpu/ops/pallas_kernels.py``;
their CUDA sources are ``csrc/<name>.cu``. On a CUDA tensor a wrapper
launches its kernel or raises; only tensors on the CPU take the plain twin.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
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


_INFO_KEYS = ("grid", "blocks_per_sm", "sms", "tiles", "items", "registers",
              "spill_bytes", "smem_bytes", "threads", "cols", "atoms", "stages",
              "vec")


def fused_perturb_launch_info(n: int, m: int, aligned: bool = True) -> dict:
    """How the kernel would launch at (N, M) on the current CUDA device: the
    persistent grid, resident blocks per SM, SMs, column tiles, work items
    (tiles x 64-row chunks), registers and spill (local) bytes a thread, shared
    memory and threads a block, the tile sizes, and whether the 16-byte
    instance runs (``aligned``: the pointers would be 16-byte aligned)."""
    fn = native.load("fused_perturb").fused_perturb_info
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_longlong * len(_INFO_KEYS))()
    err = fn(n, m, int(aligned), info)
    if err:
        raise RuntimeError(f"fused_perturb_info failed with CUDA error {err}")
    return dict(zip(_INFO_KEYS, info))


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
    if m == 0:
        raise ValueError("fused_perturb: the kernel takes at least one pixel")
    out = torch.empty_like(x)
    if n == 0:
        return out
    # The library plans the grid for the current device: make it v's.
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(v.data_ptr(), d.data_ptr(), x.data_ptr(), out.data_ptr(),
                 n, k, m, float(eps), stream)
    if err:
        raise RuntimeError(f"fused_perturb: kernel launch failed with CUDA "
                           f"error {err}")
    fused_perturb.launches += 1
    return out


fused_perturb.launches = 0


def bias_corrections(step: int, b1: float = 0.9, b2: float = 0.999) -> Tuple[float, float]:
    """``(1 - b1**step, 1 - b2**step)`` computed in fp32, as the TPU kernel's
    wrapper does; ``step`` counts from 1."""
    t = np.float32(step)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def fused_adamw_project_reference(p, g, mu, nu, step, lr, b1=0.9, b2=0.999,
                                  eps=1e-8, wd=1e-2, clip_val=1.0):
    """Plain form: one AdamW step on ``p`` and the clamp to ±clip_val.

    Returns new ``(p, mu, nu)``; the inputs are left as they were.
    """
    bc1, bc2 = bias_corrections(step, b1, b2)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mu_hat = mu / bc1
    nu_hat = nu / bc2
    p = p - lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p)
    return torch.clamp(p, -clip_val, clip_val), mu, nu


def _bind_adamw(lib: ctypes.CDLL):
    fn = lib.fused_adamw_project_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_adamw_project(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                        nu: torch.Tensor, step: int, lr: float,
                        clip_val: float = 1.0):
    """One AdamW step (betas 0.9/0.999, eps 1e-8, weight decay 1e-2) on
    ``p`` with gradient ``g``, then the clamp to ±clip_val, fused.

    ``p``, ``mu`` and ``nu`` are updated in place and returned; ``step``
    counts from 1 and ``clip_val=float('inf')`` clamps nothing. On CUDA all
    four tensors must be contiguous float32 of one shape on one device, and
    each launch adds one to ``fused_adamw_project.launches``.
    """
    tensors = (p, g, mu, nu)
    if any(t.shape != p.shape for t in tensors):
        raise ValueError("fused_adamw_project: p, g, mu and nu must have one "
                         f"shape, got {[tuple(t.shape) for t in tensors]}")
    if step < 1:
        raise ValueError(f"fused_adamw_project: step counts from 1, got {step}")
    if all(t.device.type == "cpu" for t in tensors):
        new = fused_adamw_project_reference(p, g, mu, nu, step, lr, clip_val=clip_val)
        for dst, src in zip((p, mu, nu), new):
            dst.copy_(src)
        return p, mu, nu
    if not all(t.is_cuda and t.device == p.device for t in tensors):
        raise ValueError("fused_adamw_project: p, g, mu and nu must all be on "
                         "one CUDA device (or all on the CPU)")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("fused_adamw_project: the kernel takes float32 only")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adamw_project: the kernel takes contiguous tensors only")
    fn = _bind_adamw(native.load("fused_adamw_project"))
    if p.numel() == 0:
        return p, mu, nu
    bc1, bc2 = bias_corrections(step)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = fn(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
             float(lr), bc1, bc2, float(clip_val), stream)
    if err:
        raise RuntimeError(f"fused_adamw_project: kernel launch failed with "
                           f"CUDA error {err}")
    fused_adamw_project.launches += 1
    return p, mu, nu


fused_adamw_project.launches = 0
