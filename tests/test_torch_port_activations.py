"""The port's ``ADIL_MAXPOOL`` and ``ADIL_RELU`` backward variants against
the JAX package's functions, called directly (``layers._max_pool_custom``,
``_max_pool_slices``, ``_packed_relu``, ``_bool_relu``), on tie-heavy
inputs as in ``tests/test_max_pool_vjp.py`` and ``tests/test_packed_relu.py``,
and on a ResNet-18's input gradient in each mode.

Tolerances: ``vjp``, ``bool`` and ``packed`` equal the JAX functions
exactly, values and gradients (the port adds the window taps' gradients in
the JAX function's order); ``slices`` splits the gradient of a tie as JAX
does, within 1e-6; the default ``sas`` has the JAX backward's support
exactly (first match) and its values within 1e-6 (torch and XLA add the
overlapping windows' gradients in other orders); the ResNet-18 input
gradients within 1e-4 of the JAX victim in the same mode (the zoo's
tolerance), and the bool and packed ones bit-equal to the plain one.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.models import layers as jlayers
from dl_attack_on_imagenet_tpu.ops import attack_loss as jax_attack_loss
from dl_attack_on_imagenet_tpu_torch.models import layers
from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

from _torch_port import t
from test_torch_port_zoo import zoo_pair

CASES = [
    ((3, 3), (2, 2), "SAME"),
    ((3, 3), (2, 2), ((1, 1), (1, 1))),  # the ResNet and DenseNet stem pool
    ((2, 2), (2, 2), "VALID"),
    ((3, 3), (1, 1), "SAME"),
    ((3, 3), (2, 2), "VALID"),
]


def _tied(seed: int, shape=(2, 13, 11, 4)) -> np.ndarray:
    """Integers 0..2: most windows hold equal maxima, ReLU-style zeros too."""
    x = np.random.RandomState(seed).normal(size=shape)
    return np.maximum(np.round(x), 0.0).astype(np.float32)


def _port_pool(x: np.ndarray, co: np.ndarray, window, strides, padding, mode, monkeypatch):
    monkeypatch.setattr(layers, "POOL_MODE", mode)
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = layers.max_pool(xt, window, strides, padding)
    (g,) = torch.autograd.grad(y, xt, t(co).permute(0, 3, 1, 2))
    return y.detach().permute(0, 2, 3, 1).numpy(), g.permute(0, 2, 3, 1).numpy()


def _jax_pool(fn, x, co):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(co))[0])


def _cotangent(x, window, strides, padding, seed=3):
    shape = nn.max_pool(jnp.asarray(x), window, strides=strides, padding=padding).shape
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("window,strides,padding", CASES)
def test_vjp_pool_equals_the_jax_custom_vjp_on_ties(window, strides, padding, monkeypatch):
    x = _tied(2)
    co = _cotangent(x, window, strides, padding)
    want = _jax_pool(lambda v: jlayers._max_pool_custom(v, window, strides, padding), x, co)
    got = _port_pool(x, co, window, strides, padding, "vjp", monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("window,strides,padding", CASES)
def test_slices_pool_splits_ties_as_jax_does(window, strides, padding, monkeypatch):
    x = _tied(10)
    co = _cotangent(x, window, strides, padding)
    want = _jax_pool(lambda v: jlayers._max_pool_slices(v, window, strides, padding), x, co)
    got = _port_pool(x, co, window, strides, padding, "slices", monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    # ... which differs from first-match on these ties.
    first = _port_pool(x, co, window, strides, padding, "sas", monkeypatch)
    assert np.abs(first[1] - got[1]).max() > 0.1


@pytest.mark.parametrize("window,strides,padding", CASES)
def test_default_pool_sends_ties_to_the_first_match(window, strides, padding, monkeypatch):
    x = _tied(2)
    co = _cotangent(x, window, strides, padding)
    want = _jax_pool(lambda v: nn.max_pool(v, window, strides=strides, padding=padding), x, co)
    got = _port_pool(x, co, window, strides, padding, "sas", monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1] != 0, want[1] != 0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)


def test_vjp_pool_in_bf16_equals_the_jax_custom_vjp(monkeypatch):
    x = np.random.RandomState(4).normal(size=(2, 16, 16, 8)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact
    window, strides, padding = (3, 3), (2, 2), ((1, 1), (1, 1))
    co = _cotangent(xb, window, strides, padding, seed=5)
    fn = lambda v: jlayers._max_pool_custom(v, window, strides, padding)  # noqa: E731
    y, vjp = jax.vjp(fn, jnp.asarray(xb, jnp.bfloat16))
    (jg,) = vjp(jnp.asarray(co, jnp.bfloat16))
    monkeypatch.setattr(layers, "POOL_MODE", "vjp")
    xt = t(xb).bfloat16().permute(0, 3, 1, 2).requires_grad_(True)
    yt = layers.max_pool(xt, window, strides, padding)
    (g,) = torch.autograd.grad(yt, xt, t(np.asarray(jnp.asarray(co, jnp.bfloat16).astype(
        jnp.float32))).bfloat16().permute(0, 3, 1, 2))
    np.testing.assert_array_equal(yt.float().detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(g.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jg.astype(jnp.float32)))


@pytest.mark.parametrize("c", [1, 7, 8, 13, 64])
def test_packed_mask_has_the_jax_bits(c):
    b = np.random.RandomState(c).uniform(size=(3, 5, c)) > 0.5
    want = np.asarray(jlayers._pack_bits(jnp.asarray(b)))
    got = layers.pack_bits(torch.as_tensor(b))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(layers.unpack_bits(got, c), torch.as_tensor(b))


@pytest.mark.parametrize("mode,fn", [("bool", "_bool_relu"), ("packed", "_packed_relu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_relu_equals_the_jax_function(mode, fn, dtype, monkeypatch):
    x = np.random.RandomState(0).normal(size=(2, 5, 5, 13)).astype(np.float32)
    x[0, 0, 0, :4] = 0.0  # the tie: the gradient at 0 is 0
    x[1] = np.round(x[1])
    jdt = getattr(jnp, dtype)
    co = np.random.RandomState(1).normal(size=x.shape).astype(np.float32)
    y, vjp = jax.vjp(getattr(jlayers, fn), jnp.asarray(x, jdt))
    (jg,) = vjp(jnp.asarray(co, jdt))
    monkeypatch.setattr(layers, "RELU_MODE", mode)
    tdt = getattr(torch, dtype)
    xt = t(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(tdt)
    xt = xt.permute(0, 3, 1, 2).requires_grad_(True)  # NCHW view, channels last in memory
    yt = layers.relu(xt)
    cot = t(np.asarray(jnp.asarray(co, jdt).astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    (g,) = torch.autograd.grad(yt, xt, cot)
    np.testing.assert_array_equal(yt.detach().float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(g.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jg.astype(jnp.float32)))
    assert float(g[0, 0, 0, 0]) == 0.0
    plain = torch.autograd.grad(torch.relu(xt), xt, cot)[0]
    assert torch.equal(g, plain)


def test_packed_relu_keeps_a_packed_mask_of_a_dense_layer(monkeypatch):
    # VGG's classifier ReLUs see (N, features): the mask packs along them.
    monkeypatch.setattr(layers, "RELU_MODE", "packed")
    x = torch.randn(3, 20, generator=torch.Generator().manual_seed(0), requires_grad=True)
    y = layers.relu(x)
    (mask,) = y.grad_fn.saved_tensors
    assert mask.dtype == torch.uint8 and mask.shape == (3, 3)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, (x > 0).float())


@pytest.fixture(scope="module")
def resnet_pair():
    return zoo_pair("resnet18", 32, seed=6)


MODES = [("sas", "plain"), ("vjp", "plain"), ("slices", "plain"), ("sas", "bool"),
         ("sas", "packed")]


@pytest.mark.parametrize("pool,relu", MODES)
def test_resnet18_input_gradient_in_each_mode_matches_jax(pool, relu, resnet_pair, monkeypatch):
    jv, pv = resnet_pair
    x = np.random.RandomState(7).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    labels = np.asarray([1, 3])
    monkeypatch.setattr(jlayers, "_POOL_MODE", pool)
    monkeypatch.setattr(jlayers, "_RELU_MODE", relu)
    variables = jv.variables
    fn = lambda xx: jv.module.apply(variables, (xx - jnp.asarray(layers.IMAGENET_MEAN))  # noqa: E731
                                    / jnp.asarray(layers.IMAGENET_STD))
    want = jax.grad(lambda xx: jax_attack_loss(fn(xx), jnp.asarray(labels), loss="logits"))(
        jnp.asarray(x))
    monkeypatch.setattr(layers, "POOL_MODE", pool)
    monkeypatch.setattr(layers, "RELU_MODE", relu)
    xt = t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(attack_loss(pv(xt), torch.as_tensor(labels), loss="logits"), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    monkeypatch.setattr(layers, "POOL_MODE", "sas")
    monkeypatch.setattr(layers, "RELU_MODE", "plain")
    xt = t(x).requires_grad_(True)
    (plain,) = torch.autograd.grad(attack_loss(pv(xt), torch.as_tensor(labels), loss="logits"),
                                   xt)
    if pool == "sas":  # the mask modes change no bit
        assert torch.equal(got, plain)
    else:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
