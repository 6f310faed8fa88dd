"""ConvNeXt's depthwise convolution on the CPU: the twin of the card's
``convnext_dwconv`` kernel and the kernel path around it.

On the CPU a block runs ``convnext_dwconv_reference``, which is today's
``Conv2d`` bit for bit, so every test against the plain reference keeps its
tolerance. The kernel path's wrapper and autograd plumbing run here too, on
CPU tensors that say they are on CUDA (``_OnCard``), with each launch done
in torch in the kernel's arithmetic (the forward a convolution with the
bias; the input gradient the convolution with the flipped taps plus the
residual's gradient): on ``convnext_mini`` every block takes it, once each
way a pass; its logits and input gradient agree with the module path; z's
gradient is the backward's output itself, the residual's gradient
included; the ``victim/convnext/dwconv`` span's backward opens at h's
gradient and closes at z's around the launch; the ``state_dict`` keys stay
torchvision's. The kernel's shared-memory layout, which the host works out
(``convnext_dwconv_geometry``), keeps what the kernel checks of it, and every
window reads zeros past the map; the backward reads h's gradient in the
strides a block hands it back in where a block's planes are channels of
one image. The wrapper refuses what the kernel does not take. The kernel's
own indexing is held against the twin on the card
(``tests/test_torch_port_cuda.py``).

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_convnext_dwconv.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from dl_attack_on_imagenet_tpu_torch.models import create_model, convnext
from dl_attack_on_imagenet_tpu_torch.models.convert import load_torch_checkpoint
from dl_attack_on_imagenet_tpu_torch.ops import kernels
from dl_attack_on_imagenet_tpu_torch.utils import profiling
from test_torch_port_convnext import MINI, images, mini_params, torchvision_names

torch.set_num_threads(1)

BLOCKS = sum(MINI["depths"])  # convnext_mini's blocks: 5


def _filter(c, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((c, 1, 7, 7), generator=g) * 0.15,
            torch.randn((c,), generator=g) * 0.1)


# (N, C, side): ConvNeXt-B's four stages and convnext_mini's three, small
# batches.
STAGES = [(1, 128, 56), (1, 256, 28), (2, 512, 14), (2, 1024, 7),
          (2, 16, 16), (2, 32, 8), (3, 64, 4)]


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "input_grad"])
@pytest.mark.parametrize("n,c,side", STAGES)
def test_the_twin_is_todays_module_path(n, c, side, grad):
    module = convnext.CNBlock(c).block[0].requires_grad_(False)
    module.weight.copy_(_filter(c, 0)[0])
    module.bias.copy_(_filter(c, 0)[1])
    z = torch.randn((n, c, side, side), generator=torch.Generator().manual_seed(1))
    dh = torch.randn_like(z)
    results = []
    for fn in (lambda t: kernels.convnext_dwconv_reference(t, module.weight, module.bias,
                                                            module.stride, module.padding),
               lambda t: (module(t), t)):
        zt = z.clone().requires_grad_(grad)
        h, residual = fn(zt)
        assert residual is zt
        g = torch.autograd.grad(h, zt, dh)[0] if grad else None
        results.append((h.detach(), g))
    assert torch.equal(results[0][0], results[1][0])
    if grad:
        assert torch.equal(results[0][1], results[1][1])


def test_a_cpu_block_is_todays_block():
    # The block on the CPU, forward and input gradient, bit for bit as it
    # computed before the kernel: its modules one after another.
    block = convnext.CNBlock(16).requires_grad_(False)
    with torch.no_grad():
        block.layer_scale.fill_(0.3)
    z = torch.randn((2, 16, 8, 8), generator=torch.Generator().manual_seed(2))
    dwconv, to_nhwc, norm, fc1, act, fc2, to_nchw = block.block
    outs = []
    for fn in (block, lambda t: torch.addcmul(
            t, block.layer_scale, to_nchw(fc2(act(fc1(norm(to_nhwc(dwconv(t))))))))):
        zt = z.clone().requires_grad_(True)
        y = fn(zt)
        outs.append((y.detach(), torch.autograd.grad(y.square().sum(), zt)[0]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on CUDA, so that a ConvNeXt pass on it
    takes the kernel path; every tensor computed from it is one too."""

    @property
    def is_cuda(self):
        return True


def _on_card(x):
    return x.as_subclass(_OnCard)


def _torch_launch(backward, src, weight, extra, out):
    """The kernel's arithmetic in torch ops, writing where it writes."""
    c = src.shape[1]
    src, weight, extra = (t.as_subclass(torch.Tensor) for t in (src, weight, extra))
    if backward:
        out.copy_(F.conv2d(src, weight.flip(-1, -2), None, 1, 3, 1, c) + extra)
    else:
        out.copy_(F.conv2d(src, weight, extra, 1, 3, 1, c))


@pytest.fixture()
def kernel_path(monkeypatch):
    """The kernel path on the CPU, for inputs made with :func:`_on_card`:
    each launch is the kernel's arithmetic in torch, and is logged
    (direction, output). Yields the log and the launch counts."""
    log = []

    def launch(backward, src, weight, extra, out):
        _torch_launch(backward, src, weight, extra, out)
        log.append(("backward" if backward else "forward", out))

    monkeypatch.setattr(kernels, "_launch_dwconv", launch)
    fn = kernels.convnext_dwconv
    yield log, lambda: (fn.launches, fn.backward_launches)


def _pass(victim, x, grad):
    xt = x.clone().requires_grad_(grad)
    logits = victim(xt)
    g = torch.autograd.grad(logits.square().sum(), xt)[0] if grad else None
    return logits.detach(), g


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def mini():
    return create_model("convnext_mini", device="cpu", state_dict=mini_params())


def test_every_block_takes_the_kernel_path(kernel_path, mini):
    # convnext_mini at 64², 5 blocks: one forward and one backward launch
    # each a pass with an input gradient, forwards only without. Logits
    # within 1e-6 of the largest and the input gradient within 1e-6 in
    # relative l2 of the module path's (the flipped-tap convolution sums in
    # another order than the convolution's own input gradient).
    _, counts = kernel_path
    x = images()
    before = counts()
    logits, grad = _pass(mini, _on_card(x), True)
    assert counts() == (before[0] + BLOCKS, before[1] + BLOCKS)
    with torch.no_grad():
        again = mini(_on_card(x))
    assert counts() == (before[0] + 2 * BLOCKS, before[1] + BLOCKS)
    assert torch.equal(again, logits)
    want, want_grad = _pass(mini, x, True)
    assert counts() == (before[0] + 2 * BLOCKS, before[1] + BLOCKS)
    assert float((logits - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert _rel(grad, want_grad) <= 1e-6


def test_z_gradient_is_the_backward_with_the_residuals(kernel_path):
    # One block on the kernel path: z's gradient is the very tensor the
    # backward launch wrote (no add after it), and equals the twin's, which
    # autograd sums from the convolution's input gradient and the
    # residual's; without the residual's share it would not.
    log, _ = kernel_path
    block = convnext.CNBlock(16).requires_grad_(False)
    with torch.no_grad():
        block.layer_scale.fill_(0.3)
        block.block[0].weight.copy_(_filter(16, 3)[0])
    z = torch.randn((2, 16, 8, 8), generator=torch.Generator().manual_seed(4))
    dy = torch.randn_like(z)
    zt = _on_card(z).requires_grad_(True)
    seen = []
    zt.register_hook(seen.append)
    (dz,) = torch.autograd.grad(block(zt), zt, dy)
    assert [kind for kind, _ in log] == ["forward", "backward"]
    assert seen[0].data_ptr() == log[1][1].data_ptr() == dz.data_ptr()
    zp = z.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(block(zp), zp, dy)
    assert _rel(dz, want) <= 1e-6
    assert _rel(dz - dy, want) > 1e-2  # the residual's share, dy itself, is in dz


def test_the_dwconv_backward_span_brackets_the_launch(kernel_path, monkeypatch):
    # With a profiler on, each block's ``victim/convnext/dwconv`` span
    # records one backward pair a pass: it opens at h's gradient and closes
    # at z's, and the block's backward launch falls between.
    log, _ = kernel_path
    clock = iter(range(1 << 30))
    monkeypatch.setattr(profiling, "_event", lambda: next(clock))
    victim = create_model("convnext_mini", device="cpu", seed=0)
    x = _on_card(images())
    stamps = []
    launch = kernels._launch_dwconv

    def stamped(backward, *args):
        launch(backward, *args)
        if backward:
            stamps.append(next(clock))

    monkeypatch.setattr(kernels, "_launch_dwconv", stamped)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                _pass(victim, x, True)
        pairs = [pair for name, phase, pair in profiling._RECORDER._pairs
                 if name == "victim/convnext/dwconv" and phase == "backward"]
    finally:
        profiling.reset()
    assert len(pairs) == 2 * BLOCKS and len(stamps) == 2 * BLOCKS
    # Each launch lies in one pair, and each pair holds one launch.
    for stamp in stamps:
        assert sum(start < stamp < end for start, end in pairs) == 1
    for start, end in pairs:
        assert sum(start < stamp < end for stamp in stamps) == 1


def test_the_state_dict_keys_are_unchanged(kernel_path, tmp_path):
    victim = create_model("convnext_mini", device="cpu", state_dict=mini_params())
    names = torchvision_names(MINI["dims"], MINI["depths"])
    assert list(victim.net.state_dict()) == names
    _pass(victim, _on_card(images(1)), True)
    assert list(victim.net.state_dict()) == names
    torch.save(victim.net.state_dict(), tmp_path / "convnext.pth")
    fresh = load_torch_checkpoint(str(tmp_path / "convnext.pth"),
                                  create_model("convnext_mini", device="cpu", seed=9))
    x = images()
    assert torch.equal(fresh(x), victim(x))


def test_an_empty_batch_launches_nothing(kernel_path):
    _, counts = kernel_path
    weight, bias = _filter(8, 5)
    z = _on_card(torch.zeros((0, 8, 14, 14))).requires_grad_(True)
    before = counts()
    h, residual = kernels.convnext_dwconv(z, weight, bias)
    assert h.shape == z.shape and residual.shape == z.shape
    (h.sum() + residual.sum()).backward()
    assert counts() == before


def test_other_families_keep_their_convolutions(kernel_path):
    # Only ConvNeXt's blocks call the kernel: MobileNetV2's depthwise
    # convolutions (3x3, strides 1 and 2) stay on their modules.
    _, counts = kernel_path
    before = counts()
    victim = create_model("mobilenet_v2", input_size=32, device="cpu", seed=0)
    _pass(victim, _on_card(torch.rand((2, 32, 32, 3))), True)
    assert counts() == before


def _refusal(case):
    weight, bias = _filter(8, 6)
    z = _on_card(torch.randn((2, 8, 14, 14)))
    kw = {}
    if case == "cpu":
        z = z.as_subclass(torch.Tensor)
    elif case == "kernel_5":
        weight = weight[:, :, 1:6, 1:6].contiguous()
    elif case == "stride_2":
        kw["stride"] = (2, 2)
    elif case == "padding_2":
        kw["padding"] = 2
    elif case == "non_contiguous":
        z = z.transpose(2, 3)
    elif case == "channels_last":
        z = z.contiguous(memory_format=torch.channels_last)
    elif case == "float64":
        z, weight, bias = z.double(), weight.double(), bias.double()
    elif case == "weight_grad":
        weight = weight.requires_grad_(True)
    return z, weight, bias, kw


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"), ("kernel_5", ValueError, "7x7"),
    ("stride_2", ValueError, "stride 1"), ("padding_2", ValueError, "padding 3"),
    ("non_contiguous", ValueError, "contiguous"), ("channels_last", ValueError, "contiguous"),
    ("float64", TypeError, "float32"), ("weight_grad", ValueError, "no gradient")])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(kernel_path, case, error, match):
    _, counts = kernel_path
    z, weight, bias, kw = _refusal(case)
    before = counts()
    with pytest.raises(error, match=match):
        kernels.convnext_dwconv(z, weight, bias, **kw)
    assert counts() == before
    if case == "weight_grad":  # without autograd it runs
        with torch.no_grad():
            kernels.convnext_dwconv(z, weight, bias)


def test_the_launch_refuses_cpu_tensors():
    weight, bias = _filter(4, 7)
    z = torch.randn((1, 4, 7, 7))
    with pytest.raises(ValueError, match="CUDA"):
        kernels._launch_dwconv(False, z, weight, bias, torch.empty_like(z))


# (H, W): ConvNeXt-B's maps and convnext_mini's; maps 7 does not divide,
# with ragged tiles; and maps over 128 tiles, cut into bands of rows (the
# last one short).
GEOMETRY_SHAPES = [(56, 56), (28, 28), (14, 14), (7, 7), (16, 16), (8, 8), (4, 4), (9, 13),
                   (1, 1), (21, 35), (60, 44), (300, 8), (150, 60)]


@pytest.mark.parametrize("h,w", GEOMETRY_SHAPES, ids=lambda v: str(v))
def test_the_layout_keeps_the_kernels_rules_and_zero_borders(h, w):
    # What the kernel's valid() asks of the host's layout, and, for every
    # band of rows a block takes, that each thread's window lies in the
    # block's maps and that the windows of the outputs it keeps read, past
    # the map, only slots no plane's data is copied to (the zero border
    # shared between rows and between planes).
    tile, band_rows, bands, per_block, pitch, stride, map_floats = (
        kernels.convnext_dwconv_geometry(h, w))
    tiles_x, band_tiles = -(-w // tile), band_rows // tile
    assert tile in (4, 7) and band_rows % tile == 0 and band_rows * bands >= h
    assert bands == 1 or per_block == 1
    assert per_block * band_tiles * tiles_x <= 128 and pitch >= w + 3
    assert map_floats % 4 == 0 and 4 * (map_floats + per_block * 49) <= 232448
    origin = 3 * pitch + 3
    planes = np.arange(per_block)[:, None, None]
    for y0 in range(0, h, band_rows):
        ys = np.arange(max(0, y0 - 3), min(h, y0 + band_rows + 3))[None, :, None]
        written = (origin + planes * stride + (ys - y0) * pitch + np.arange(w)).ravel()
        assert len(np.unique(written)) == written.size
        reach = origin + planes * stride + np.array([-3, band_rows + 2])[:, None] * pitch
        reach = reach + np.array([-3, tiles_x * tile + 2])
        assert reach.min() >= 0 and reach.max() < map_floats
        rows = np.arange(-3, min(band_rows, h - y0) + 3)[None, :, None]
        cols = np.arange(-3, w + 3)[None, None, :]
        window = origin + planes * stride + rows * pitch + cols
        past = np.broadcast_to((y0 + rows < 0) | (y0 + rows >= h) | (cols < 0) | (cols >= w),
                               window.shape)
        assert not np.isin(window[past], written).any()


# (N, C, side): h's gradient as the block hands it back, channels_last
# strides, which the kernel reads as they are where a block's planes are
# channels of one image: ConvNeXt-B's maps (2, 8, 32 and 128 planes a
# block) and convnext_mini's 16² and 8²; at 4² a block's 128 planes span
# images, and at 28² with 12 channels a block's 8 planes would too, so the
# backward copies the gradient to NCHW first; contiguous NCHW is read as
# it is.
CHANNELS_LAST = [(1, 4, 56, "cl", True), (2, 16, 28, "cl", True), (1, 64, 14, "cl", True),
                 (2, 128, 7, "cl", True), (2, 16, 16, "cl", True), (2, 32, 8, "cl", True),
                 (2, 64, 4, "cl", False), (1, 12, 28, "cl", False), (2, 16, 28, "nchw", False)]


@pytest.mark.parametrize("n,c,side,layout,direct", CHANNELS_LAST)
def test_which_gradients_the_kernel_reads_channels_last(n, c, side, layout, direct):
    dh = torch.randn((n, side, side, c)).permute(0, 3, 1, 2)
    if layout == "nchw":
        dh = dh.contiguous()
    assert kernels._reads_channels_last(dh) == direct


def test_the_geometry_of_convnext_b_and_mini():
    # Whole planes and 7x7 tiles at ConvNeXt-B's maps, 128 threads' worth
    # of tiles a block; 4x4 tiles at convnext_mini's; the least layout (a
    # row w + 3 floats, a plane h + 3 rows); within a block's shared memory.
    want = {56: (7, 2), 28: (7, 8), 14: (7, 32), 7: (7, 128), 16: (4, 8), 8: (4, 32),
            4: (4, 128)}
    for side, (tile, per_block) in want.items():
        geometry = kernels.convnext_dwconv_geometry(side, side)
        t, band_rows, bands, p, pitch, stride, map_floats = geometry
        assert (t, bands, p) == (tile, 1, per_block) and band_rows == -(-side // t) * t
        assert pitch == side + 3 and stride == (side + 3) * pitch
        assert 4 * (map_floats + p * 49) <= 232448
