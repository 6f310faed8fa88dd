"""Port victims against the JAX victims with the same weights: logits and
the CW-loss input gradient within 1e-4 (ResNets at 64x64 and the tiny CNN,
batch 2, BatchNorm statistics randomized). Each victim's memory layout:
every convolution of an fp32 victim takes contiguous NCHW tensors and every
one of a bf16 victim channels_last ones, in each form of each family, and
an fp32 victim computes what its weights forced into channels_last do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from dl_attack_on_imagenet_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.ops import attack_loss as jax_attack_loss
from dl_attack_on_imagenet_tpu_torch.models import (MODEL_REGISTRY, create_model,
                                                    fast_victim_kwargs)
from dl_attack_on_imagenet_tpu_torch.models.tiny import same_pads
from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

from _torch_port import t, victim_pair


@pytest.mark.parametrize("name,size", [("tiny", None), ("resnet18", 64), ("resnet50", 64)])
def test_logits_and_input_gradient_match_jax(name, size):
    """The fp32 port against the JAX victim computed in float64, the value
    both fp32 summation orders round: on this input one ReLU input of the
    ResNet-50 lies within fp32 rounding of 0 (exactly 5.4e-7; -1.7e-6 in
    an NHWC fp32 order, XLA's and channels_last's), so an fp32 order that
    flips it parts from the other by 5e-4 in the input gradient."""
    jv, variables, pv = victim_pair(name, input_size=size)
    rs = np.random.RandomState(1)
    x = rs.uniform(0.0, 1.0, (2, pv.input_size, pv.input_size, 3)).astype(np.float32)
    labels = np.asarray([1, 3])

    with jax.enable_x64(True):
        vars64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jv64 = jax_create_model(name, input_size=size, dtype=jnp.float64, variables=vars64)
        x64 = jnp.asarray(x, jnp.float64)
        want = np.asarray(jv64.apply_fn(vars64, x64))
        jgrad = jax.grad(lambda xx: jax_attack_loss(
            jv64.apply_fn(vars64, xx), jnp.asarray(labels), loss="logits"))(x64)
    xt = t(x).requires_grad_(True)
    logits = pv(xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-4, rtol=0)

    (grad,) = torch.autograd.grad(
        attack_loss(logits, torch.as_tensor(labels), loss="logits"), xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,layout", [(torch.float32, torch.contiguous_format),
                                          (torch.bfloat16, torch.channels_last)])
def test_victims_are_frozen_and_channels_last(dtype, layout):
    """Frozen, in eval mode, with the dtype's layout: contiguous NCHW
    weights for fp32 (cuDNN's fp32 kernels are NCHW), channels_last for
    bf16; the NHWC input's NCHW view is channels_last either way. The
    victim's ``memory_format`` is read off its weights, so it follows them
    when they are moved to the other layout."""
    victim = create_model("resnet18", input_size=32, device="cpu", dtype=dtype)
    assert not victim.training
    assert not any(p.requires_grad for p in victim.parameters())
    assert victim.memory_format == layout
    weight = victim.net.conv1.weight
    assert weight.is_contiguous(memory_format=layout)
    assert weight.is_contiguous() == (layout == torch.contiguous_format)
    x = torch.rand(2, 32, 32, 3)
    assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    assert victim(x).shape == (2, 1000)
    assert victim.predict(x).shape == (2,)
    other = torch.channels_last if layout == torch.contiguous_format else torch.contiguous_format
    victim.net.to(memory_format=other)
    assert victim.memory_format == other


def test_seeded_weights_are_reproducible():
    a = create_model("tiny", device="cpu", seed=3)
    b = create_model("tiny", device="cpu", seed=3)
    c = create_model("tiny", device="cpu", seed=4)
    x = torch.rand(2, 32, 32, 3)
    assert torch.equal(a(x), b(x))
    assert not torch.equal(a(x), c(x))
    assert a.num_classes == 10 and a.norm is None  # tiny: no normalization


def test_registry_and_unported_names():
    """The JAX registry's names, sizes and constructors, and exactly the
    port's own Swin besides (which the JAX package lacks)."""
    assert set(MODEL_REGISTRY) - set(JAX_REGISTRY) == {"swin_b", "swin_tiny"}
    shared = {k: size for k, (_, size) in MODEL_REGISTRY.items() if k in JAX_REGISTRY}
    assert shared == {k: size for k, (_, size) in JAX_REGISTRY.items()}
    for key in shared:
        assert MODEL_REGISTRY[key][0].__name__ == JAX_REGISTRY[key][0].__name__
    assert {k: size for k, (_, size) in MODEL_REGISTRY.items() if k not in JAX_REGISTRY} == {
        "swin_b": 224, "swin_tiny": 64}
    with pytest.raises(ValueError, match="unknown model 'alexnet'"):
        create_model("alexnet", device="cpu")


def test_same_pads_match_xla():
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(16, 3, 2) == (0, 1)
    assert same_pads(15, 3, 2) == (1, 1)
    assert same_pads(8, 3, 1) == (1, 1)


def test_resnet34_builds_from_jax_variables():
    jv, variables, pv = victim_pair("resnet34", input_size=32)
    x = np.random.RandomState(2).uniform(0.0, 1.0, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jv.apply_fn(variables, jnp.asarray(x)))
    np.testing.assert_allclose(pv(t(x)).detach().numpy(), want, atol=1e-4, rtol=0)


# One victim of each family of the registry, at a small size, in each of its
# forms: plain, the S2D stem (the families with one), folded (those with
# conv -> BatchNorm) and fast, the S2D stem folded, as ``--fast-victim``
# builds it (the families with both).
_FAMILIES = [("resnet18", 32), ("resnet50", 32), ("densenet121", 32), ("googlenet", 32),
             ("inception_v3", 75), ("mobilenet_v2", 32), ("vgg11", 32), ("vit_tiny", 32),
             ("tiny", None)]
_S2D = ("resnet18", "resnet50", "densenet121", "googlenet")
_FOLD = ("resnet18", "resnet50", "googlenet", "inception_v3", "mobilenet_v2")
_FORMS = ([(name, size, "plain") for name, size in _FAMILIES]
          + [(name, size, "stem_s2d") for name, size in _FAMILIES if name in _S2D]
          + [(name, size, "folded") for name, size in _FAMILIES if name in _FOLD]
          + [(name, size, "fast") for name, size in _FAMILIES if name in _S2D and name in _FOLD])
_FORM_KWARGS = {"plain": lambda name: {}, "stem_s2d": lambda name: {"stem_s2d": True},
                "folded": lambda name: {"fold_bn": True}, "fast": fast_victim_kwargs}


def _victim(name, size, form, dtype=torch.float32):
    """The victim of ``form`` and the NHWC input it takes."""
    victim = create_model(name, input_size=size, device="cpu", dtype=dtype,
                          **_FORM_KWARGS[form](name))
    x = torch.rand((2, victim.input_size, victim.input_size, 3),
                   generator=torch.Generator().manual_seed(5))
    return victim, x


class _Convolutions(TorchFunctionMode):
    """The input and weight of every ``F.conv2d`` call made under it: the
    modules' own and the S2D stem's, which convolves ``conv1``'s blocked
    kernel without calling the module."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.calls.append((args[0], args[1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,size,form", _FORMS)
def test_every_convolution_takes_the_victims_layout(name, size, form, dtype):
    """Forward pre-hooks on every ``nn.Conv2d`` and every ``F.conv2d`` call
    of a forward pass: input and weight contiguous NCHW in an fp32 victim,
    channels_last in a bf16 one. A single channels_last tensor would turn
    the rest of an fp32 net back to channels_last, where cuDNN transposes
    around its NCHW fp32 kernels."""
    victim, x = _victim(name, size, form, dtype)
    layout = torch.contiguous_format if dtype == torch.float32 else torch.channels_last
    assert victim.memory_format == layout
    modules = [m for m in victim.net.modules() if isinstance(m, nn.Conv2d)]
    hooked = []
    handles = [m.register_forward_pre_hook(lambda m, args: hooked.append((args[0], m.weight)))
               for m in modules]
    try:
        with _Convolutions() as convs:
            victim(x)
    finally:
        for h in handles:
            h.remove()
    # Every convolution runs once: through its module, or (the S2D stem's
    # conv1) through F.conv2d on its blocked kernel.
    assert len(convs.calls) == len(modules)
    assert len(hooked) == len(modules) - (form in ("stem_s2d", "fast"))
    for inp, weight in hooked + convs.calls:
        assert inp.is_contiguous(memory_format=layout)
        assert weight.is_contiguous(memory_format=layout)


@pytest.mark.parametrize("name,size,form", _FORMS)
def test_fp32_victim_computes_what_its_channels_last_weights_do(name, size, form):
    """An fp32 victim's logits equal those of the same weights forced into
    channels_last, the layout fp32 victims had before, within 1e-5 of their
    largest value; run in float64, its logits and NHWC input gradient equal
    theirs within 1e-12. The fp32 input gradients are not compared: a ReLU
    input within fp32 rounding of 0 flips with the summation order (in
    Inception-v3 at 75x75 one does, and the two layouts' gradients part by
    1% of their largest value), while float64 holds every sign."""
    victim, x = _victim(name, size, form)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        # An fp32 victim casts its input to fp32; as float64 it keeps it.
        victim.to(dtype).dtype = dtype
        for layout in (torch.contiguous_format, torch.channels_last):
            victim.net.to(memory_format=layout)
            xt = x.to(dtype).requires_grad_(True)
            logits = victim(xt)
            (grad,) = torch.autograd.grad(logits.square().sum(), xt)
            runs[dtype, layout] = (logits.detach(), grad)

    def gap(dtype, i):
        """Logits (0) or gradient (1), NCHW against channels_last."""
        a, b = runs[dtype, torch.contiguous_format][i], runs[dtype, torch.channels_last][i]
        return float((a - b).abs().max()) / float(b.abs().max())

    assert gap(torch.float32, 0) <= 1e-5
    assert gap(torch.float64, 0) <= 1e-12 and gap(torch.float64, 1) <= 1e-12
