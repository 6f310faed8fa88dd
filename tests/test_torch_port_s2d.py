"""The port's space-to-depth layout against the JAX package's: the layout
itself, the S2D stems of ResNet-18, DenseNet-121 and GoogLeNet, the odd-size
fallback, the deferred stem ReLU at ties, and the blocked twin.

Weights are drawn in numpy for the JAX module's variable shapes
(``test_torch_port_zoo.zoo_pair``), with the stem under ``S2DStem_0``, and
carried into the port by ``state_dict_from_flax``.

Tolerances: logits and the CW input gradient within 1e-4 of the JAX
package's (the zoo's tolerance), and of the port's plain stem; the twin on
blocked images within 1e-5 of the victim on the images (one convolution
summed in another order); the ReLU before and after the max pool exactly
equal. DenseNet-121 is held against the JAX package in its logits at full
depth and in its gradient at two dense layers a block (a full-depth JAX
gradient compiles for 15 s on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dl_attack_on_imagenet_tpu.models import blocked_twin as jax_blocked_twin
from dl_attack_on_imagenet_tpu.models.densenet import DenseNet as JaxDenseNet
from dl_attack_on_imagenet_tpu.models.layers import depth_to_space as jax_depth_to_space
from dl_attack_on_imagenet_tpu.models.layers import space_to_depth as jax_space_to_depth
from dl_attack_on_imagenet_tpu_torch.models import (VictimModel, blocked_twin, create_model,
                                                    depth_to_space, space_to_depth)
from dl_attack_on_imagenet_tpu_torch.models.convert import state_dict_from_flax
from dl_attack_on_imagenet_tpu_torch.models.densenet import DenseNet
from dl_attack_on_imagenet_tpu_torch.models.layers import max_pool

from _torch_port import t
from test_torch_port_zoo import MEAN, STD, _check_logits_and_gradient, _images, _variables, zoo_pair

ATOL = 1e-4


def _grad(victim, x, labels=(1, 3)):
    xt = x.clone().requires_grad_(True)
    logits = victim(xt)
    margin = logits[torch.arange(len(x)), torch.as_tensor(labels[:len(x)])].sum()
    (g,) = torch.autograd.grad(margin - logits.logsumexp(-1).sum(), xt)
    return logits.detach(), g


def _against_plain_and_twin(pv, plain, x):
    """``pv`` (S2D stem) against ``plain`` (same weights, plain stem), and
    its blocked twin against it; returns the twin's logits."""
    (l_s2d, g_s2d), (l_plain, g_plain) = _grad(pv, t(x)), _grad(plain, t(x))
    np.testing.assert_allclose(l_s2d.numpy(), l_plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(g_s2d.numpy(), g_plain.numpy(), atol=ATOL, rtol=0)
    # The twin on the blocked images: the victim's function, and its
    # gradient the space-to-depth of the victim's.
    l_twin, g_twin = _grad(blocked_twin(pv), space_to_depth(t(x)))
    np.testing.assert_allclose(l_twin.numpy(), l_s2d.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_twin.numpy(), space_to_depth(g_s2d).numpy(), atol=1e-5, rtol=0)
    return l_twin


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 4, 12), (3, 2, 2, 1)])
def test_space_to_depth_matches_jax(shape):
    x = np.random.RandomState(0).normal(size=shape).astype(np.float32)
    got = space_to_depth(t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_space_to_depth(jnp.asarray(x))))
    assert got.is_contiguous()
    back = depth_to_space(got)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_depth_to_space(jax_space_to_depth(jnp.asarray(x)))))


@pytest.mark.parametrize("name", ["resnet18", "googlenet"])
def test_s2d_victim_matches_jax_and_the_plain_stem(name):
    jv, pv = zoo_pair(name, 32, stem_s2d=True)
    assert "S2DStem_0" in jv.variables["params"] and pv.net.stem_s2d
    x = _images(32)
    _check_logits_and_gradient(jv, pv, x)
    plain = create_model(name, input_size=32, state_dict=pv.net.state_dict(), device="cpu")
    assert not plain.net.stem_s2d
    l_twin = _against_plain_and_twin(pv, plain, x)
    want = np.asarray(jax_blocked_twin(jv)(jax_space_to_depth(jnp.asarray(x))))
    np.testing.assert_allclose(l_twin.numpy(), want, atol=ATOL, rtol=0)


def test_s2d_densenet_matches_jax_and_the_plain_stem():
    jv, pv = zoo_pair("densenet121", 32, stem_s2d=True)
    assert "S2DStem_0" in jv.variables["params"] and pv.net.stem_s2d
    x = _images(32)
    np.testing.assert_allclose(pv(t(x)).numpy(), np.asarray(jv(jnp.asarray(x))), atol=ATOL, rtol=0)
    plain = create_model("densenet121", input_size=32, state_dict=pv.net.state_dict(),
                         device="cpu")
    _against_plain_and_twin(pv, plain, x)
    # The gradient against the JAX package at two dense layers a block.
    kw = dict(block_config=(2, 2), growth_rate=8, num_init_features=16, num_classes=10)
    module = JaxDenseNet(stem_s2d=True, **kw)
    variables = _variables(module, 32, seed=0)
    assert "S2DStem_0" in variables["params"]
    net = DenseNet(stem_s2d=True, **kw)
    net.load_state_dict(state_dict_from_flax(variables))
    shallow = VictimModel("densenet", net.to(memory_format=torch.channels_last), 32).eval()
    shallow.requires_grad_(False)
    apply = jax.jit(lambda xx: module.apply(variables, (xx - MEAN) / STD))
    _check_logits_and_gradient(apply, shallow, x)


def test_odd_size_falls_back_to_the_plain_stem():
    # At 33x33 the JAX module builds its plain ConvBN stem; the port's S2D
    # build takes the same weights and runs its plain path.
    jv, pv = zoo_pair("resnet18", 33, stem_s2d=True)
    assert "ConvBN_0" in jv.variables["params"] and pv.net.stem_s2d
    x = np.random.RandomState(1).uniform(0.0, 1.0, (2, 33, 33, 3)).astype(np.float32)
    _check_logits_and_gradient(jv, pv, x)
    plain = create_model("resnet18", input_size=33, state_dict=pv.net.state_dict(), device="cpu")
    assert torch.equal(pv(t(x)), plain(t(x)))


@pytest.mark.parametrize("padding", [((1, 1), (1, 1)), "SAME"])
@pytest.mark.parametrize("quantize", [False, True])
def test_deferred_relu_commutes_with_the_pool_at_ties(padding, quantize):
    # The S2D stems apply their ReLU after the max pool; rounded inputs give
    # equal maxima and exact zeros in most windows.
    y = torch.randn((2, 5, 12, 12), generator=torch.Generator().manual_seed(int(quantize)))
    if quantize:
        y = torch.round(y)
    co = torch.randn((2, 5, 6, 6), generator=torch.Generator().manual_seed(9))
    grads, values = [], []
    for before in (True, False):
        yy = y.clone().requires_grad_(True)
        out = (max_pool(F.relu(yy), 3, 2, padding) if before
               else F.relu(max_pool(yy, 3, 2, padding)))
        (g,) = torch.autograd.grad((out * co).sum(), yy)
        values.append(out.detach())
        grads.append(g)
    assert torch.equal(values[0], values[1])
    assert torch.equal(grads[0], grads[1])


def test_blocked_twin_keeps_the_normalization_and_transform_input():
    _, pv = zoo_pair("googlenet", 32, stem_s2d=True)
    assert pv.net.transform is not None
    keys = list(pv.state_dict())
    twin = blocked_twin(pv)
    assert twin is blocked_twin(pv) and twin.net is pv.net and twin.blocked_input
    assert list(pv.state_dict()) == keys  # the twin is not a submodule
    assert (twin.mean, twin.std) == (pv.mean, pv.std)
    x = t(_images(32))
    np.testing.assert_allclose(twin(space_to_depth(x)).numpy(), pv(x).numpy(), atol=1e-5, rtol=0)
    xb = space_to_depth(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(
        twin.net.transform(twin.norm(xb)).numpy(),
        space_to_depth(pv.net.transform(pv.norm(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1))
        .permute(0, 3, 1, 2).numpy(), atol=1e-6, rtol=0)
    unnormalized = create_model("resnet18", input_size=32, device="cpu", normalize=False,
                                stem_s2d=True)
    assert blocked_twin(unnormalized).norm is None
    assert blocked_twin(create_model("resnet18", input_size=32, device="cpu")) is None
    assert blocked_twin(create_model("tiny", device="cpu")) is None
    blocked = create_model("resnet18", input_size=32, device="cpu", blocked_input=True)
    assert blocked.net.stem_s2d and blocked_twin(blocked) is blocked
    with pytest.raises(TypeError):
        create_model("vgg11", input_size=32, device="cpu", stem_s2d=True)
