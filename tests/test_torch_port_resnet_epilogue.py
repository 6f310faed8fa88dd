"""The ResNet post-convolution path on the CPU: what follows each
convolution (frozen BatchNorm, the residual add where a block ends, ReLU).

On the CPU the blocks run their modules one after another, the twin of the
card's ``resnet_epilogue`` kernel: that composition is today's, bit for bit,
for ResNet-18 and ResNet-50 block shapes (7x7 maps included), folded and
unfolded, with and without an input gradient, so every test against the JAX
package keeps its tolerance. The kernel path's dispatch, wrapper and
autograd plumbing run here too, on CPU tensors that say they are on CUDA,
with the launch done by plain torch ops in the kernel's arithmetic: every
site of a ResNet takes it (49 on ResNet-50), under every ``ADIL_RELU``; its
output and gradients agree with the composition; the paths that keep the
composition on the card (a bf16 victim, the S2D stem, a BatchNorm in
training mode) launch nothing; and a channels_last map raises, since the
card has no fallback. ``create_model``'s ``state_dict`` keys are
torchvision's, before and after a kernel pass.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from dl_attack_on_imagenet_tpu_torch.models import create_model, layers, resnet
from dl_attack_on_imagenet_tpu_torch.models.fold import fold_batchnorms_
from dl_attack_on_imagenet_tpu_torch.ops import kernels


def _random_bn_(net, gen):
    """Running statistics and affines away from the identity, so that every
    BatchNorm moves its input."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(c, generator=gen) * 0.6 + 0.4)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.3)
    return net


def _block(kind, inplanes, planes, stride, folded, seed=0):
    gen = torch.Generator().manual_seed(seed)
    cls = resnet.BasicBlock if kind == "basic" else resnet.Bottleneck
    block = cls(inplanes, planes, stride)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
    _random_bn_(block, gen)
    if folded:
        fold_batchnorms_(block)
    return block.eval().requires_grad_(False)


def _by_hand(block, x):
    """Today's block, written out from its modules."""
    if isinstance(block, resnet.Bottleneck):
        y = block.relu(block.bn1(block.conv1(x)))
        y = block.relu(block.bn2(block.conv2(y)))
        y = block.bn3(block.conv3(y))
    else:
        y = block.relu(block.bn1(block.conv1(x)))
        y = block.bn2(block.conv2(y))
    residual = x if block.downsample is None else block.downsample(x)
    return block.relu(y + residual)


# (kind, in channels, planes, stride, input side): ResNet-18 and ResNet-50
# blocks, with and without a downsample branch, their output maps 7x7 and
# 14x14 (stage 4 and 3 at 224) and one odd side.
BLOCKS = [("basic", 64, 64, 1, 14), ("basic", 256, 512, 2, 14), ("basic", 512, 512, 1, 7),
          ("bottleneck", 256, 64, 1, 14), ("bottleneck", 1024, 512, 2, 14),
          ("bottleneck", 2048, 512, 1, 7), ("bottleneck", 64, 16, 2, 9)]


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "input_grad"])
@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("kind,cin,planes,stride,side", BLOCKS)
def test_the_twin_is_todays_composition(kind, cin, planes, stride, side, folded, grad):
    block = _block(kind, cin, planes, stride, folded)
    x = torch.randn((2, cin, side, side), generator=torch.Generator().manual_seed(1))
    outs = []
    for fn in (block, lambda t: _by_hand(block, t)):
        xt = x.clone().requires_grad_(grad)
        y = fn(xt)
        g = torch.autograd.grad(y.square().sum(), xt)[0] if grad else None
        outs.append((y.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    if grad:
        assert torch.equal(outs[0][1], outs[1][1])


def test_the_stem_is_todays_composition():
    victim = create_model("resnet18", input_size=32, device="cpu", seed=2)
    net = victim.net
    _random_bn_(net, torch.Generator().manual_seed(3))
    x = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(4))
    want = net.maxpool(net.relu(net.bn1(net.conv1(x))))
    got = net.maxpool(resnet.conv_bn_relu(x, net.conv1, net.bn1, net.relu))
    assert torch.equal(got, want)


def _torch_launch(backward, tensors, x, mode):
    """The kernel's arithmetic in torch ops, writing where it writes."""
    view = lambda t: t.view(1, -1, 1, 1)
    if not backward:
        xy, r, a, b, ra, rb = tensors
        t = torch.addcmul(view(b), xy, view(a))
        if mode == kernels._IDENTITY:
            t = t + r
        elif mode == kernels._AFFINE:
            t = t + torch.addcmul(view(rb), r, view(ra))
        xy.copy_(torch.where(t <= 0, torch.zeros_like(t), t))
        return
    g, y, a, ra, dx, dr = tensors
    kept = torch.where(y <= 0, torch.zeros_like(g), g)
    dx.copy_(kept * view(a))
    if mode == kernels._IDENTITY:
        dr.copy_(kept)
    elif mode == kernels._AFFINE:
        dr.copy_(kept * view(ra))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on CUDA, so that a ResNet pass on it
    takes the kernel path; every tensor computed from it is one too."""

    @property
    def is_cuda(self):
        return True


def _on_card(x):
    return x.as_subclass(_OnCard)


@pytest.fixture()
def kernel_path(monkeypatch):
    """The kernel path on the CPU, for inputs made with :func:`_on_card`:
    each launch is the kernel's arithmetic in torch. Yields the launch
    counts as a function."""
    monkeypatch.setattr(kernels, "_launch_epilogue", _torch_launch)
    fn = kernels.resnet_epilogue
    yield lambda: (fn.launches, fn.backward_launches)


def _pass(victim, x, grad):
    xt = x.clone().requires_grad_(grad)
    logits = victim(xt)
    g = torch.autograd.grad(logits.square().sum(), xt)[0] if grad else None
    return logits.detach(), g


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


SITES = {"resnet18": 17, "resnet50": 49}


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_every_site_takes_the_kernel_path(kernel_path, name, folded):
    # In float32 the kernel path's logits are within fp32 rounding of the
    # composition's, and its input gradient within 1e-4 in relative l2 (a
    # ReLU input within rounding of 0 may flip).
    victim = create_model(name, input_size=32, device="cpu", seed=5, fold_bn=folded)
    if not folded:
        _random_bn_(victim.net, torch.Generator().manual_seed(6))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(7))
    counts = kernel_path
    before = counts()
    logits, grad = _pass(victim, _on_card(x), True)
    assert counts() == (before[0] + SITES[name], before[1] + SITES[name])
    with torch.no_grad():
        again = victim(_on_card(x))
    assert counts() == (before[0] + 2 * SITES[name], before[1] + SITES[name])
    assert torch.equal(again, logits)
    want, want_grad = _pass(victim, x, True)
    assert counts() == (before[0] + 2 * SITES[name], before[1] + SITES[name])
    assert float((logits - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert _rel(grad, want_grad) <= 1e-4


def test_the_kernel_path_is_the_composition_in_float64(kernel_path, monkeypatch):
    # With the dtype checks widened to float64 (the autograd function
    # called without the wrapper), the kernel path and the composition of
    # one float64 ResNet-50 agree to float64 rounding: the affines, the
    # downsample branch and the gradients of both inputs.
    net = resnet.resnet50(num_classes=10)
    _random_bn_(net, torch.Generator().manual_seed(8))
    net = net.double().eval().requires_grad_(False)
    x = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(9),
                   dtype=torch.float64)
    plain = resnet._takes_kernel

    def takes(t, conv, bn):
        return plain(t.float(), conv, bn)

    monkeypatch.setattr(resnet, "_takes_kernel", takes)
    monkeypatch.setattr(resnet, "resnet_epilogue", lambda y, a, b, r=None, ra=None, rb=None:
                        kernels._ResNetEpilogue.apply(y, a, b, r, ra, rb))
    results = []
    for kernel in (True, False):
        xt = (_on_card(x) if kernel else x).clone().requires_grad_(True)
        y = net(xt)
        results.append((y.detach(), torch.autograd.grad(y.square().sum(), xt)[0]))
    (y, g), (want, want_g) = results
    assert float((y - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert _rel(g, want_g) <= 1e-10


@pytest.mark.parametrize("case", ["bf16", "relu_bool", "relu_packed", "s2d_stem",
                                  "bn_training", "channels_last"])
def test_the_dispatch_keeps_todays_path(kernel_path, monkeypatch, case):
    # Where a pass off the default keeps today's modules and where it does
    # not: a bf16 victim keeps them at every site, the S2D stem at its own,
    # a BatchNorm in training mode at its one site. ``ADIL_RELU`` bool and
    # packed do not reach the kernel path, which takes all 49 sites. A
    # channels_last fp32 map raises: the card has no fallback.
    kw = {"dtype": torch.bfloat16} if case == "bf16" else {}
    if case == "s2d_stem":
        kw["stem_s2d"] = True
    # 64x64 keeps every map of a channels_last net over 1x1, where a map is
    # contiguous in both layouts.
    victim = create_model("resnet50", input_size=64, device="cpu", seed=5, **kw)
    if case.startswith("relu_"):
        monkeypatch.setattr(layers, "RELU_MODE", case[5:])
    if case == "bn_training":
        victim.net.layer2[0].bn2.train()
    if case == "channels_last":
        victim.net.to(memory_format=torch.channels_last)
    x = _on_card(torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(7)))
    counts = kernel_path
    before = counts()
    if case == "channels_last":
        with pytest.raises(ValueError, match="contiguous"):
            _pass(victim, x, True)
        assert counts() == before
        return
    _pass(victim, x, True)
    want = {"s2d_stem": 48, "bn_training": 48, "relu_bool": 49, "relu_packed": 49}.get(case, 0)
    assert counts() == (before[0] + want, before[1] + want)


def _torchvision_resnet50_keys():
    keys = ["conv1.weight"] + [f"bn1.{k}" for k in ("weight", "bias", "running_mean",
                                                     "running_var", "num_batches_tracked")]
    bn = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            p = f"layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                keys += [f"{p}.conv{i}.weight"] + [f"{p}.bn{i}.{k}" for k in bn]
            if b == 0:
                keys += [f"{p}.downsample.0.weight"] + [f"{p}.downsample.1.{k}" for k in bn]
    return keys + ["fc.weight", "fc.bias"]


def test_the_state_dict_keys_are_unchanged(kernel_path):
    victim = create_model("resnet50", input_size=32, device="cpu", seed=5)
    want = _torchvision_resnet50_keys()
    assert sorted(victim.net.state_dict()) == sorted(want) and len(want) == 320
    _pass(victim, _on_card(torch.rand((1, 32, 32, 3))), True)  # caches each site's affine
    assert sorted(victim.net.state_dict()) == sorted(want)
    assert all(not k.startswith("_") for k, _ in victim.net.named_buffers())


def test_the_affine_follows_a_load_and_a_fold(kernel_path):
    # The cached scale and shift are rebuilt when the BatchNorm's tensors
    # change in place (a load) and when a fold replaces them.
    victim = create_model("resnet18", input_size=32, device="cpu", seed=5)
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        victim(_on_card(x))
        state = {k: v.clone() for k, v in victim.net.state_dict().items()}
        _random_bn_(victim.net, torch.Generator().manual_seed(10))
        moved = victim(_on_card(x))
        want = victim(x)
        assert float((moved - want).abs().max()) <= 1e-5 * float(want.abs().max())
        fold_batchnorms_(victim.net)
        assert float((victim(_on_card(x)) - want).abs().max()) <= 1e-5 * float(want.abs().max())
        victim2 = create_model("resnet18", input_size=32, device="cpu", state_dict=state)
        scale, _ = resnet._affine(victim2.net.conv1, victim2.net.bn1)
        assert torch.equal(scale, torch.rsqrt(torch.ones(64, dtype=torch.float64)
                                              + 1e-5).float())


def test_an_epilogue_without_autograd_writes_in_place_and_saves_nothing(kernel_path):
    x = torch.randn((2, 4, 3, 3))
    scale, shift = torch.rand(4) + 0.5, torch.randn(4)
    want = F.relu(x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1))
    y = x.clone()
    with torch.no_grad():
        out = kernels.resnet_epilogue(y, scale, shift)
    assert out is y and y.grad_fn is None
    assert float((y - want).abs().max()) <= 1e-6


def test_the_kernel_path_refuses_a_batchnorm_that_needs_a_gradient(kernel_path):
    # The kernel gives the BatchNorm no gradient, so a trainable one raises
    # under autograd and runs without it.
    victim = create_model("resnet18", input_size=32, device="cpu", seed=5)
    victim.net.layer1[0].bn1.weight.requires_grad_(True)
    x = _on_card(torch.rand((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="no gradient"):
        victim(x)
    with torch.no_grad():
        victim(x)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    x, scale = torch.randn((2, 4, 3, 3)), torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.resnet_epilogue(x, scale, scale)
