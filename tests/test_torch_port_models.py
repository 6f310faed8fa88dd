"""Port victims against the JAX victims with the same weights: logits and
the CW-loss input gradient within 1e-4 (ResNets at 64x64 and the tiny CNN,
batch 2, BatchNorm statistics randomized)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from dl_attack_on_imagenet_tpu.ops import attack_loss as jax_attack_loss
from dl_attack_on_imagenet_tpu_torch.models import MODEL_REGISTRY, create_model
from dl_attack_on_imagenet_tpu_torch.models.tiny import same_pads
from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

from _torch_port import t, victim_pair


@pytest.mark.parametrize("name,size", [("tiny", None), ("resnet18", 64), ("resnet50", 64)])
def test_logits_and_input_gradient_match_jax(name, size):
    jv, variables, pv = victim_pair(name, input_size=size)
    rs = np.random.RandomState(1)
    x = rs.uniform(0.0, 1.0, (2, pv.input_size, pv.input_size, 3)).astype(np.float32)
    labels = np.asarray([1, 3])

    want = np.asarray(jv.apply_fn(variables, jnp.asarray(x)))
    xt = t(x).requires_grad_(True)
    logits = pv(xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-4, rtol=0)

    jgrad = jax.grad(lambda xx: jax_attack_loss(
        jv.apply_fn(variables, xx), jnp.asarray(labels), loss="logits"))(jnp.asarray(x))
    (grad,) = torch.autograd.grad(
        attack_loss(logits, torch.as_tensor(labels), loss="logits"), xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-4, rtol=0)


def test_victims_are_frozen_and_channels_last():
    victim = create_model("resnet18", input_size=32, device="cpu")
    assert not victim.training
    assert not any(p.requires_grad for p in victim.parameters())
    assert victim.net.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    x = torch.rand(2, 32, 32, 3)
    assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    assert victim(x).shape == (2, 1000)
    assert victim.predict(x).shape == (2,)


def test_seeded_weights_are_reproducible():
    a = create_model("tiny", device="cpu", seed=3)
    b = create_model("tiny", device="cpu", seed=3)
    c = create_model("tiny", device="cpu", seed=4)
    x = torch.rand(2, 32, 32, 3)
    assert torch.equal(a(x), b(x))
    assert not torch.equal(a(x), c(x))
    assert a.num_classes == 10 and a.norm is None  # tiny: no normalization


def test_registry_and_unported_names():
    assert {k: size for k, (_, size) in MODEL_REGISTRY.items()} == {
        k: size for k, (_, size) in JAX_REGISTRY.items()}
    for key, (ctor, _) in MODEL_REGISTRY.items():
        assert ctor.__name__ == JAX_REGISTRY[key][0].__name__
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
