"""Hand-written CUDA kernels of the port, each beside its plain torch twin.

``fused_perturb`` and ``fused_adamw_project`` replace the Pallas TPU kernels
of the same names in ``dl_attack_on_imagenet_tpu/ops/pallas_kernels.py``;
``swin_window_attention`` (Swin's windowed attention, forward and input
gradient) replaces none: the JAX package has no Swin; nor does
``resnet_epilogue`` (a ResNet's frozen BatchNorm, residual add and ReLU
after a convolution, forward and input gradient), which XLA fuses on the
TPU; nor does ``convnext_dwconv`` (ConvNeXt's 7x7 depthwise convolution,
forward and input gradient with the residual's gradient summed in): the
JAX package has no ConvNeXt; nor does ``xcit_xca`` (the core of XCiT's
cross-covariance attention, from the qkv Linear's output to the proj
Linear's input, forward and input gradient): the JAX package has no XCiT.
Their CUDA sources are ``csrc/<name>.cu``. On a CUDA tensor a wrapper
launches its kernel or raises; only tensors on the CPU take the plain twin.
The Swin, ResNet, ConvNeXt and XCiT wrappers take CUDA tensors only: each
twin is the model's own path (``models.swin.window_attention_reference``,
the ResNet's ``bn`` -> ``+`` -> ``relu`` modules,
:func:`convnext_dwconv_reference`, ``models.xcit.xca_reference``), and the
model picks one or the other by what its call observes.
"""

from __future__ import annotations

import ctypes
import functools
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


# (window, head dim) pairs the window-attention kernel is built for: Swin-B's
# every stage, and the small test Swin's.
SWIN_WINDOW_SHAPES = ((7, 32), (4, 8))


def _swin_head_dim(qkv, table, window: int, shift_h: int, shift_w: int, heads: int) -> int:
    """Check a window attention's shapes; returns the head dim."""
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"swin_window_attention: qkv must be (N, H, W, 3 x {heads} heads x "
                         f"head dim), got {tuple(qkv.shape)}")
    _, h, w, c3 = qkv.shape
    head_dim = c3 // (3 * heads)
    if (window, head_dim) not in SWIN_WINDOW_SHAPES:
        raise ValueError(f"swin_window_attention: no kernel for window {window} with head dim "
                         f"{head_dim}; (window, head dim) must be one of {SWIN_WINDOW_SHAPES}")
    if h % window or w % window:
        raise ValueError(f"swin_window_attention: {window}x{window} windows do not tile a "
                         f"{h}x{w} map")
    if not (0 <= shift_h < window and 0 <= shift_w < window):
        raise ValueError(f"swin_window_attention: shifts ({shift_h}, {shift_w}) outside "
                         f"[0, {window})")
    if tuple(table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"swin_window_attention: the bias table must be "
                         f"({(2 * window - 1) ** 2}, {heads}), got {tuple(table.shape)}")
    return head_dim


def _bind_swin(lib: ctypes.CDLL):
    fwd = lib.swin_window_attention_forward_f32
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    bwd = lib.swin_window_attention_backward_f32
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _launch_swin(fn, pointers, qkv, geometry) -> bool:
    """One launch of the forward or backward on ``qkv``'s device and current
    stream, none for an empty batch; whether it launched. ``geometry`` is
    (window, head dim, shift_h, shift_w, heads)."""
    window, head_dim, shift_h, shift_w, heads = geometry
    n, h, w, _ = qkv.shape
    if n == 0:
        return False
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(*pointers, n, h, w, heads, window, head_dim, shift_h, shift_w, stream)
    if err:
        raise RuntimeError(f"swin_window_attention: kernel launch failed with CUDA error {err}")
    return True


class _SwinWindowAttention(torch.autograd.Function):
    """The kernel's forward, and its backward for qkv's gradient; the
    forward saves qkv and each score row's log-sum-exp, not the scores."""

    @staticmethod
    def forward(ctx, qkv, table, geometry):
        n, h, w, c3 = qkv.shape
        window, heads = geometry[0], geometry[-1]
        out = qkv.new_empty((n, h, w, c3 // 3))
        lse = qkv.new_empty((n * (h // window) * (w // window), heads, window * window))
        fwd, _ = _bind_swin(native.load("swin_window_attention"))
        if _launch_swin(fwd, (qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                              lse.data_ptr()), qkv, geometry):
            swin_window_attention.launches += 1
        ctx.save_for_backward(qkv, table, lse)
        ctx.geometry = geometry
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        qkv, table, lse = ctx.saved_tensors
        grad = grad.contiguous()
        dqkv = torch.empty_like(qkv)
        _, bwd = _bind_swin(native.load("swin_window_attention"))
        if _launch_swin(bwd, (qkv.data_ptr(), table.data_ptr(), lse.data_ptr(),
                              grad.data_ptr(), dqkv.data_ptr()), qkv, ctx.geometry):
            swin_window_attention.backward_launches += 1
        return dqkv, None, None


def swin_window_attention(qkv: torch.Tensor, table: torch.Tensor, window: int, shift_h: int,
                          shift_w: int, heads: int) -> torch.Tensor:
    """A Swin block's windowed attention between its qkv and proj Linears.

    Args:
      qkv: (N, H, W, 3C) output of the qkv Linear on the unrolled map, its
        channels q, k, v, each heads x head dim.
      table: ((2 window - 1)², heads) relative-position bias table.
      window: the window's side; shift_h, shift_w: the cyclic shift of the
        shifted-window blocks on each axis (0 for a plain window block).

    Returns the (N, H, W, C) attention output in map order: the map rolled
    by (-shift_h, -shift_w), cut into windows, softmax(q kᵀ / sqrt(head
    dim) + bias + mask) v in each window and head, and put back and rolled
    back, as :func:`~..models.swin.window_attention_reference` does on the
    CPU. The kernel does it all, forward and qkv's gradient; every input
    must be contiguous float32 on one CUDA device, and the table may not
    require a gradient while autograd records (the kernel gives it none).
    Each forward launch adds one to ``swin_window_attention.launches``,
    each backward to ``swin_window_attention.backward_launches``. Only
    (window, head dim) pairs in ``SWIN_WINDOW_SHAPES`` are taken.
    """
    head_dim = _swin_head_dim(qkv, table, window, shift_h, shift_w, heads)
    if table.requires_grad and torch.is_grad_enabled():
        raise ValueError("swin_window_attention: the kernel gives the bias table no gradient; "
                         "freeze it (create_model does) or run without autograd")
    if not all(t.is_cuda and t.device == qkv.device for t in (qkv, table)):
        raise ValueError("swin_window_attention: qkv and the table must both be on one CUDA "
                         "device (the CPU takes models.swin.window_attention_reference)")
    if not all(t.dtype == torch.float32 for t in (qkv, table)):
        raise TypeError("swin_window_attention: the kernel takes float32 only")
    if not (qkv.is_contiguous() and table.is_contiguous()) or qkv.data_ptr() % 16:
        raise ValueError("swin_window_attention: the kernel takes contiguous tensors, qkv "
                         "16-byte aligned")
    return _SwinWindowAttention.apply(qkv, table, (window, head_dim, shift_h, shift_w, heads))


swin_window_attention.launches = 0
swin_window_attention.backward_launches = 0


# The residual modes of the ResNet epilogue kernel (csrc/resnet_epilogue.cu).
_NO_RESIDUAL, _IDENTITY, _AFFINE = 0, 1, 2
_EPILOGUE_FNS = {}


def _bind_epilogue():
    """The kernel's forward and backward entry points, bound once a library
    (a ResNet pass calls them 49 times each way)."""
    lib = native.load("resnet_epilogue")
    fns = _EPILOGUE_FNS.get(lib)
    if fns is None:
        fwd, bwd = lib.resnet_epilogue_forward_f32, lib.resnet_epilogue_backward_f32
        fwd.argtypes = bwd.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        fns = _EPILOGUE_FNS[lib] = (fwd, bwd)
    return fns


def _pointer(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_epilogue(backward: bool, tensors, x: torch.Tensor, mode: int) -> None:
    """One launch of the forward (``tensors`` = x, r, a, b, a', b') or the
    backward (g, y, a, a', dx, dr) over ``x``'s map, on ``x``'s device and
    current stream; None entries are null pointers. Raises off CUDA."""
    if not x.is_cuda:
        raise ValueError("resnet_epilogue: the kernel runs on CUDA tensors only (the CPU takes "
                         "the model's BatchNorm, add and ReLU)")
    fn = _bind_epilogue()[1 if backward else 0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(_pointer(t) for t in tensors), x.numel(), x.shape[2] * x.shape[3],
                 x.shape[1], mode, stream)
    if err:
        raise RuntimeError(f"resnet_epilogue: kernel launch failed with CUDA error {err}")


def _epilogue_forward(x, scale, shift, residual, res_scale, res_shift) -> int:
    """y over x in place; returns the residual mode."""
    mode = _NO_RESIDUAL if residual is None else _IDENTITY if res_scale is None else _AFFINE
    if x.numel():
        _launch_epilogue(False, (x, residual, scale, shift, res_scale, res_shift), x, mode)
        resnet_epilogue.launches += 1
    return mode


class _ResNetEpilogue(torch.autograd.Function):
    """The kernel's forward, written over the convolution's output, and its
    backward for the gradients of that output and of the residual; it
    saves the output alone (and the per-channel scales)."""

    @staticmethod
    def forward(ctx, x, scale, shift, residual, res_scale, res_shift):
        ctx.mode = _epilogue_forward(x, scale, shift, residual, res_scale, res_shift)
        ctx.mark_dirty(x)
        ctx.save_for_backward(x, scale, res_scale)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        y, scale, res_scale = ctx.saved_tensors
        grad = grad.contiguous()
        if grad.data_ptr() % 16:
            grad = grad.clone()
        mode = ctx.mode if ctx.needs_input_grad[3] else _NO_RESIDUAL
        dx = torch.empty_like(y)
        dr = torch.empty_like(y) if mode != _NO_RESIDUAL else None
        if y.numel():
            _launch_epilogue(True, (grad, y, scale, res_scale, dx, dr), y, mode)
            resnet_epilogue.backward_launches += 1
        return dx, None, None, dr, None, None


def resnet_epilogue(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    residual: torch.Tensor = None, res_scale: torch.Tensor = None,
                    res_shift: torch.Tensor = None) -> torch.Tensor:
    """What follows a ResNet convolution, in one pass: its frozen BatchNorm
    (a per-channel affine), the residual add where a block ends, and the
    ReLU.

    Args:
      x: (N, C, H, W) output of the convolution, without its bias.
      scale, shift: (C,) the BatchNorm's ``gamma / sqrt(var + eps)`` and
        ``beta - mean * scale``, the convolution's bias folded in (a folded
        victim's are 1 and the bias).
      residual: None; or the block's input, added as it is; or, with
        ``res_scale`` and ``res_shift``, the downsample convolution's raw
        output, added through its own BatchNorm's affine.

    Returns ``relu(scale x + shift [+ residual'])``, written over ``x`` (the
    convolution's output, which nothing else reads). Under autograd the
    backward gives x's gradient (``scale`` times the output's gradient where
    the output is positive) and the residual's, from the saved output alone;
    the scales and shifts get none (``models.resnet`` refuses a BatchNorm
    that needs one). Every tensor must be contiguous float32
    on one CUDA device, 16-byte aligned, the map under 2^31 elements. Each
    forward launch adds one to ``resnet_epilogue.launches``, each backward to
    ``resnet_epilogue.backward_launches``.
    """
    if x.dim() != 4:
        raise ValueError(f"resnet_epilogue: x must be (N, C, H, W), got {tuple(x.shape)}")
    channels = x.shape[1]
    affines = [scale, shift] + ([res_scale, res_shift] if res_scale is not None else [])
    if (res_scale is None) != (res_shift is None) or (res_scale is not None and residual is None):
        raise ValueError("resnet_epilogue: res_scale and res_shift go together, with a residual")
    if any(tuple(t.shape) != (channels,) for t in affines):
        raise ValueError(f"resnet_epilogue: scales and shifts must be ({channels},), got "
                         f"{[tuple(t.shape) for t in affines]}")
    maps = [x] + ([residual] if residual is not None else [])
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"resnet_epilogue: the residual {tuple(residual.shape)} does not match "
                         f"x {tuple(x.shape)}")
    tensors = maps + affines
    if not all(t.device == x.device for t in tensors):
        raise ValueError("resnet_epilogue: every tensor must be on x's device")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("resnet_epilogue: the kernel takes float32 only")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("resnet_epilogue: the kernel takes contiguous (NCHW) tensors, 16-byte "
                         "aligned")
    if x.numel() >= 1 << 31:
        raise ValueError(f"resnet_epilogue: the kernel takes maps under 2^31 elements, got "
                         f"{x.numel()}")
    if residual is not None and residual.untyped_storage().data_ptr() == (
            x.untyped_storage().data_ptr()):
        raise ValueError("resnet_epilogue: the residual may not share x's memory, which the "
                         "kernel overwrites")
    if torch.is_grad_enabled() and (x.requires_grad or (residual is not None
                                                        and residual.requires_grad)):
        return _ResNetEpilogue.apply(x, scale, shift, residual, res_scale, res_shift)
    _epilogue_forward(x, scale, shift, residual, res_scale, res_shift)
    return x


resnet_epilogue.launches = 0
resnet_epilogue.backward_launches = 0


# The ConvNeXt depthwise kernel (csrc/convnext_dwconv.cu): its threads a
# block, the shared memory a block may use on an H100, the border a plane
# keeps in shared memory, and the taps of a filter.
_DWCONV_THREADS, _DWCONV_SHARED_BYTES, _DWCONV_HALO, _DWCONV_TAPS = 128, 232448, 3, 49


@functools.lru_cache(maxsize=None)
def convnext_dwconv_geometry(h: int, w: int) -> Tuple[int, ...]:
    """How the depthwise kernel lays out an h x w map: (tile, band_rows,
    bands, per_block, pitch, plane_stride, map_floats).

    Each thread computes a tile x tile block of outputs: 7 where 7 divides
    both sides (every ConvNeXt-B map at 224²), else 4. A block of 128
    threads takes ``per_block`` whole planes where a plane has at most 128
    tiles (``bands`` 1, ``band_rows`` the plane's tile rows), else one band
    of ``band_rows`` rows of one plane, ``bands`` a plane. In shared memory
    a row takes ``pitch`` = w + 3 floats (the gap after a row is the zero
    border of that row and of the next) and a plane ``plane_stride`` = its
    rows plus 3 times the pitch, likewise; ``map_floats`` holds the planes
    to the last window's far corner. Raises on a map over 128 tiles wide or
    over a block's shared memory.
    """
    tile = 7 if h % 7 == 0 and w % 7 == 0 else 4
    tiles_x, tiles_y = -(-w // tile), -(-h // tile)
    if tiles_x > _DWCONV_THREADS:
        raise ValueError(f"convnext_dwconv: a {h}x{w} map is over {_DWCONV_THREADS} tiles of "
                         f"{tile} wide; the kernel takes maps up to {_DWCONV_THREADS * tile} wide")
    if tiles_x * tiles_y <= _DWCONV_THREADS:
        band_tiles, bands, per_block = tiles_y, 1, _DWCONV_THREADS // (tiles_x * tiles_y)
    else:
        band_tiles = _DWCONV_THREADS // tiles_x
        bands, per_block = -(-tiles_y // band_tiles), 1
    band_rows, halo = band_tiles * tile, _DWCONV_HALO
    pitch = w + halo
    plane_stride = ((h if bands == 1 else band_rows) + halo) * pitch
    last = (halo * pitch + halo + (per_block - 1) * plane_stride
            + (band_rows + halo - 1) * pitch + tiles_x * tile + halo - 1)
    map_floats = -(-(last + 1) // 4) * 4
    if 4 * (map_floats + per_block * _DWCONV_TAPS) > _DWCONV_SHARED_BYTES:
        raise ValueError(f"convnext_dwconv: a {h}x{w} map does not fit a block's shared memory")
    return tile, band_rows, bands, per_block, pitch, plane_stride, map_floats


def convnext_dwconv_reference(z: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              stride=1, padding=3):
    """The plain twin of :func:`convnext_dwconv`: the block's ``Conv2d`` as
    it computes in fp32, and z itself for the residual."""
    return torch.nn.functional.conv2d(z, weight, bias, stride, padding, 1, z.shape[1]), z


_DWCONV_FNS = {}


def _bind_dwconv():
    lib = native.load("convnext_dwconv")
    fn = _DWCONV_FNS.get(lib)
    if fn is None:
        fn = lib.convnext_dwconv_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _DWCONV_FNS[lib] = fn
    return fn


def _reads_channels_last(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` (N, C, H, W) in its channels_last
    strides as they are: where they are not contiguous NCHW, and a block's
    planes are channels of one image that its threads share out (whole
    planes, their count dividing C and the block's 128 threads)."""
    if t.is_contiguous() or not t.is_contiguous(memory_format=torch.channels_last):
        return False
    _, c, h, w = t.shape
    _, _, bands, per_block = convnext_dwconv_geometry(h, w)[:4]
    return bands == 1 and c % per_block == 0 and _DWCONV_THREADS % per_block == 0


def _launch_dwconv(backward: bool, src: torch.Tensor, weight: torch.Tensor,
                   extra: torch.Tensor, out: torch.Tensor) -> None:
    """One launch over ``src``'s (N, C, H, W) map into ``out``, on ``src``'s
    device and current stream: the forward (``extra`` the bias) or the input
    gradient (``src`` h's gradient, read in its channels_last strides where
    :func:`_reads_channels_last` takes them, else copied to NCHW first;
    ``extra`` the residual's). Raises off CUDA. A ConvNeXt-B pass launches
    72 times, so the host's part is kept short: no device switch where the
    tensor is on the current device, and the raw stream handle."""
    if not src.is_cuda:
        raise ValueError("convnext_dwconv: the kernel runs on CUDA tensors only (the CPU takes "
                         "convnext_dwconv_reference)")
    n, c, h, w = src.shape
    bias, res = (None, extra) if backward else (extra, None)
    channels_last = _reads_channels_last(src)
    if not channels_last:
        src = src.contiguous()
    device = src.get_device()
    args = (src.data_ptr(), weight.data_ptr(), _pointer(bias), _pointer(res), out.data_ptr(),
            int(backward), int(channels_last), n * c, c, h, w, *convnext_dwconv_geometry(h, w))
    if device == torch._C._cuda_getDevice():
        err = _bind_dwconv()(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = _bind_dwconv()(*args, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"convnext_dwconv: kernel launch failed with CUDA error {err}")


def _dwconv_forward(z, weight, bias) -> torch.Tensor:
    h = torch.empty_like(z)
    if z.numel():
        _launch_dwconv(False, z, weight, bias, h)
        convnext_dwconv.launches += 1
    return h


class _ConvNeXtDWConv(torch.autograd.Function):
    """The kernel's forward, returning h and z itself (the residual's z),
    so that both of z's gradients reach the one backward: the kernel's
    input gradient over h's gradient with the residual's added. It saves
    the weight alone."""

    @staticmethod
    def forward(ctx, z, weight, bias):
        ctx.save_for_backward(weight)
        return _dwconv_forward(z, weight, bias), z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_h, grad_residual):
        (weight,) = ctx.saved_tensors
        grad_residual = grad_residual.contiguous()
        dz = torch.empty_like(grad_residual)
        if dz.numel():
            _launch_dwconv(True, grad_h, weight, grad_residual, dz)
            convnext_dwconv.backward_launches += 1
        return dz, None, None


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def convnext_dwconv(z: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride=1,
                    padding=3):
    """A ConvNeXt block's 7x7 depthwise convolution, and z for its residual.

    Args:
      z: (N, C, H, W) the block's input, contiguous NCHW float32.
      weight: (C, 1, 7, 7) and bias (C,): the block's depthwise ``Conv2d``;
        stride and padding its own, which must be 1 and 3.

    Returns (h, residual): h = the convolution of z plus the bias, and
    residual, z itself for the block's ``z + layer_scale * m``. Under
    autograd the two go through one backward: z's gradient is the kernel's
    input gradient over h's gradient with the residual's gradient added in
    the same pass, so nothing else sums the two. The weight and bias get no
    gradient, and may not require one while autograd records. Every tensor
    must be float32 and contiguous on z's CUDA device, the map under 2^31
    elements. Each forward launch adds one to ``convnext_dwconv.launches``,
    each backward to ``convnext_dwconv.backward_launches``; an empty batch
    launches nothing.
    """
    if z.dim() != 4:
        raise ValueError(f"convnext_dwconv: z must be (N, C, H, W), got {tuple(z.shape)}")
    n, c, h, w = z.shape
    if weight.shape != (c, 1, 7, 7):
        raise ValueError(f"convnext_dwconv: the kernel takes a 7x7 depthwise weight ({c}, 1, 7, "
                         f"7), got {tuple(weight.shape)}")
    if bias is None or bias.shape != (c,):
        raise ValueError(f"convnext_dwconv: the bias must be ({c},)")
    if _pair(stride) != (1, 1) or _pair(padding) != (3, 3):
        raise ValueError(f"convnext_dwconv: the kernel takes stride 1 and padding 3, got stride "
                         f"{stride} and padding {padding}")
    if not (z.is_cuda and weight.device == z.device and bias.device == z.device):
        raise ValueError("convnext_dwconv: z, the weight and the bias must be on one CUDA device "
                         "(the CPU takes convnext_dwconv_reference)")
    if not (z.dtype == weight.dtype == bias.dtype == torch.float32):
        raise TypeError("convnext_dwconv: the kernel takes float32 only")
    if not (z.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("convnext_dwconv: the kernel takes contiguous (NCHW) tensors")
    if z.numel() >= 1 << 31:
        raise ValueError(f"convnext_dwconv: the kernel takes maps under 2^31 elements, got "
                         f"{z.numel()}")
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        raise ValueError("convnext_dwconv: the kernel gives the weight and bias no gradient; "
                         "freeze them (create_model does) or run without autograd")
    convnext_dwconv_geometry(h, w)  # raises on a map the kernel cannot hold
    if torch.is_grad_enabled() and z.requires_grad:
        return _ConvNeXtDWConv.apply(z, weight, bias)
    return _dwconv_forward(z, weight, bias), z


convnext_dwconv.launches = 0
convnext_dwconv.backward_launches = 0


# Head dims the XCA kernel is built for: XCiT-L12's (16 heads of 48) and the
# small test XCiT's (4 heads of 16).
XCIT_XCA_HEAD_DIMS = (48, 16)
_XCA_FNS = {}


def _bind_xca():
    lib = native.load("xcit_xca")
    fns = _XCA_FNS.get(lib)
    if fns is None:
        fwd, bwd = lib.xcit_xca_forward_f32, lib.xcit_xca_backward_f32
        fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
        fns = _XCA_FNS[lib] = (fwd, bwd)
    return fns


def _launch_xca(backward: bool, pointers, qkv: torch.Tensor, heads: int) -> None:
    """One launch of the forward or the backward over ``qkv``'s (B, N, 3C)
    rows, on its device and current stream."""
    b, n, c3 = qkv.shape
    device = qkv.get_device()
    args = (*pointers, b, n, heads, c3 // (3 * heads))
    fn = _bind_xca()[1 if backward else 0]
    if device == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if err:
        raise RuntimeError(f"xcit_xca: kernel launch failed with CUDA error {err}")


class _XCiTXCA(torch.autograd.Function):
    """The kernel's forward, and its backward for qkv's gradient; the
    forward saves qkv and, a head, Ŝ = q̂ k̂ᵀ and the norms of q and k
    (d² + 2d floats), not q̂, k̂ or the softmax."""

    @staticmethod
    def forward(ctx, qkv, temperature, heads):
        b, n, c3 = qkv.shape
        d = c3 // (3 * heads)
        out = qkv.new_empty((b, n, c3 // 3))
        saved = qkv.new_empty((b, heads, d * d + 2 * d))
        if out.numel():
            _launch_xca(False, (qkv.data_ptr(), temperature.data_ptr(), out.data_ptr(),
                                saved.data_ptr()), qkv, heads)
            xcit_xca.launches += 1
        ctx.save_for_backward(qkv, temperature, saved)
        ctx.heads = heads
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        qkv, temperature, saved = ctx.saved_tensors
        grad = grad.contiguous()
        if grad.data_ptr() % 16:
            grad = grad.clone()
        dqkv = torch.empty_like(qkv)
        if dqkv.numel():
            _launch_xca(True, (qkv.data_ptr(), temperature.data_ptr(), saved.data_ptr(),
                               grad.data_ptr(), dqkv.data_ptr()), qkv, ctx.heads)
            xcit_xca.backward_launches += 1
        return dqkv, None, None


def xcit_xca(qkv: torch.Tensor, temperature: torch.Tensor, heads: int) -> torch.Tensor:
    """The core of an XCiT block's cross-covariance attention, between its
    qkv and proj Linears.

    Args:
      qkv: (B, N, 3C) output of the qkv Linear, its channels q, k, v, each
        heads x head dim.
      temperature: the ``heads`` temperatures τ (timm's (heads, 1, 1)).

    Returns the (B, N, C) input of the proj Linear: in each image and head,
    with q, k and v the head's channels over the tokens,
    ``softmax(τ q̂ k̂ᵀ) v`` in token-row order, q̂ and k̂ l2-normalized over
    the tokens as ``F.normalize`` does (eps 1e-12), the softmax over the last
    axis; :func:`~..models.xcit.xca_reference` computes it on the CPU. The
    kernel does it all, forward and qkv's gradient; qkv must be contiguous
    float32, 16-byte aligned, and the temperature float32 on qkv's CUDA
    device; the temperature may not require a gradient while autograd
    records (the kernel gives it none). Each forward launch adds one to
    ``xcit_xca.launches``, each backward to ``xcit_xca.backward_launches``;
    an empty batch launches nothing. Only head dims in
    ``XCIT_XCA_HEAD_DIMS`` are taken.
    """
    if qkv.dim() != 3 or heads < 1 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"xcit_xca: qkv must be (B, N, 3 x {heads} heads x head dim), got "
                         f"{tuple(qkv.shape)}")
    head_dim = qkv.shape[-1] // (3 * heads)
    if head_dim not in XCIT_XCA_HEAD_DIMS:
        raise ValueError(f"xcit_xca: no kernel for head dim {head_dim}; it must be one of "
                         f"{XCIT_XCA_HEAD_DIMS}")
    if temperature.numel() != heads:
        raise ValueError(f"xcit_xca: {temperature.numel()} temperatures for {heads} heads")
    if temperature.requires_grad and torch.is_grad_enabled():
        raise ValueError("xcit_xca: the kernel gives the temperature no gradient; freeze it "
                         "(create_model does) or run without autograd")
    if not (qkv.dtype == temperature.dtype == torch.float32):
        raise TypeError("xcit_xca: the kernel takes float32 only")
    if not (qkv.is_contiguous() and temperature.is_contiguous()) or qkv.data_ptr() % 16:
        raise ValueError("xcit_xca: the kernel takes contiguous tensors, qkv 16-byte aligned")
    if not (qkv.is_cuda and temperature.device == qkv.device):
        raise ValueError("xcit_xca: qkv and the temperature must both be on one CUDA device "
                         "(the CPU takes models.xcit.xca_reference)")
    return _XCiTXCA.apply(qkv, temperature, heads)


xcit_xca.launches = 0
xcit_xca.backward_launches = 0
