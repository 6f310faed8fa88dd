"""The port's victim zoo against the JAX package's. Both packages get the
same random weights: every variable of the JAX module (its shapes from
``jax.eval_shape``, so no JAX initialization runs) is drawn in numpy,
BatchNorm statistics, LayerNorms and ViT's class token included, and carried
into the port by ``state_dict_from_flax``.

Checked: logits and the CW-loss input gradient within 1e-4 at reduced
depth, width or input size for every family; the full-depth DenseNet-121
and MobileNetV2 logits at 32x32; the "SAME" max pool against the JAX
package's padding rule; torchvision checkpoints with auxiliary heads; and
the BatchNorm fold (within 1e-5 of the unfolded logits: the same fp32
products, scaled before rather than after).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.models.densenet import DenseNet as JaxDenseNet
from dl_attack_on_imagenet_tpu.models.layers import _pool_pads
from dl_attack_on_imagenet_tpu.models.layers import max_pool as jax_max_pool
from dl_attack_on_imagenet_tpu.ops import attack_loss as jax_attack_loss
from dl_attack_on_imagenet_tpu_torch.models import VictimModel, create_model
from dl_attack_on_imagenet_tpu_torch.models.convert import (
    load_torch_checkpoint, state_dict_from_flax)
from dl_attack_on_imagenet_tpu_torch.models.densenet import DenseNet
from dl_attack_on_imagenet_tpu_torch.models.fold import fold_victim
from dl_attack_on_imagenet_tpu_torch.models.layers import max_pool, pool_pads
from dl_attack_on_imagenet_tpu_torch.ops import attack_loss

from _torch_port import t

ATOL = 1e-4
MEAN, STD = jnp.asarray([0.485, 0.456, 0.406]), jnp.asarray([0.229, 0.224, 0.225])


def _draw(tree, rs: np.random.RandomState, parent: str = ""):
    """Random numpy values for a tree of shapes: LeCun-normal kernels, small
    biases, BatchNorm and LayerNorm terms and statistics around 1 and 0."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _draw(leaf, rs, key)
            continue
        shape = leaf.shape
        if key in ("scale", "var"):
            value = rs.uniform(0.5, 1.5, shape)
        elif key == "mean" or (key == "bias" and parent.startswith(("BatchNorm", "LayerNorm"))):
            value = rs.normal(0.0, 0.1, shape)
        elif key == "kernel":  # attention's "out" kernel is (heads, head_dim, features)
            fan_in = np.prod(shape[:2] if parent == "out" else shape[:-1])
            value = rs.normal(0.0, 1.0, shape) / np.sqrt(fan_in)
        elif key == "bias":
            value = rs.normal(0.0, 0.01, shape)
        else:  # ViT's class token and position embedding
            value = rs.normal(0.0, 0.5, shape)
        out[key] = value.astype(np.float32)
    return out


def _variables(module, size: int, seed: int):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    return _draw(shapes, np.random.RandomState(seed))


def zoo_pair(name: str, size: int, seed: int = 0, **kwargs):
    """(JAX victim, port victim on the CPU) of registry ``name`` at input
    ``size`` with the same random weights."""
    variables = _variables(JAX_REGISTRY[name][0](**kwargs), size, seed)
    jv = jax_create_model(name, input_size=size, variables=variables, **kwargs)
    pv = create_model(name, input_size=size, state_dict=state_dict_from_flax(variables),
                      device="cpu", **kwargs)
    return jv, pv


def _images(size: int, n: int = 2, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).uniform(0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _check_logits_and_gradient(jax_fn, pv, x, labels=(1, 3)):
    labels = np.asarray(labels[:len(x)])
    want = np.asarray(jax_fn(jnp.asarray(x)))
    xt = t(x).requires_grad_(True)
    logits = pv(xt)
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=ATOL, rtol=0)
    jgrad = jax.grad(lambda xx: jax_attack_loss(jax_fn(xx), jnp.asarray(labels),
                                                loss="logits"))(jnp.asarray(x))
    (grad,) = torch.autograd.grad(attack_loss(logits, torch.as_tensor(labels), loss="logits"), xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,size,kwargs", [
    ("mobilenet_v2", 32, {}),
    ("googlenet", 32, {}),
    ("googlenet", 32, {"transform_input": False}),
    ("inception_v3", 75, {}),  # its smallest input
    ("vgg11", 32, {"hidden": 64}),
    ("vgg11", 224, {"hidden": 64}),  # a 7x7 map: the classifier reads 25088 features
    ("vit_tiny", 32, {}),
])
def test_family_matches_jax(name, size, kwargs):
    jv, pv = zoo_pair(name, size, **kwargs)
    assert pv.input_size == size
    x = _images(size, n=1) if size == 224 else _images(size)
    _check_logits_and_gradient(jv, pv, x)


def test_shallow_densenet_matches_jax():
    kw = dict(block_config=(2, 2), growth_rate=8, num_init_features=16, num_classes=10)
    module = JaxDenseNet(**kw)
    variables = _variables(module, 32, seed=0)
    net = DenseNet(**kw)
    net.load_state_dict(state_dict_from_flax(variables))
    pv = VictimModel("densenet", net, 32).eval()
    pv.requires_grad_(False)
    assert list(dict(net.features.named_children())) == [
        "conv0", "norm0", "relu0", "pool0", "denseblock1", "transition1", "denseblock2", "norm5"]
    apply = jax.jit(lambda xx: module.apply(variables, (xx - MEAN) / STD))
    _check_logits_and_gradient(apply, pv, _images(32))


@pytest.mark.parametrize("name", ["densenet121", "mobilenet_v2"])
def test_full_depth_registry_builds_match_jax(name):
    jv, pv = zoo_pair(name, 32)
    x = _images(32, n=1, seed=2)
    np.testing.assert_allclose(pv(t(x)).detach().numpy(), np.asarray(jv(jnp.asarray(x))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("size", [224, 112, 15, 32])
@pytest.mark.parametrize("window,strides", [(3, 2), (3, 1), (2, 2)])
def test_same_max_pool_follows_the_jax_pads(size, window, strides):
    win, st = (window, window), (strides, strides)
    assert pool_pads(size, size, win, st, "SAME") == _pool_pads(size, size, win, st, "SAME")
    x = np.random.RandomState(size).normal(size=(1, size, size, 4)).astype(np.float32)
    want = np.asarray(jax_max_pool(jnp.asarray(x), win, st, "SAME"))
    got = max_pool(t(x).permute(0, 3, 1, 2), window, strides, "SAME").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_same_max_pool_pads_the_bottom_and_right_at_112():
    assert pool_pads(112, 112, (3, 3), (2, 2), "SAME") == ((0, 1), (0, 1))
    assert pool_pads(15, 15, (3, 3), (2, 2), "SAME") == ((1, 1), (1, 1))
    assert pool_pads(9, 9, (3, 3), (2, 2), ((1, 1), (1, 1))) == ((1, 1), (1, 1))


@pytest.mark.parametrize("name,aux", [("googlenet", ("aux1", "aux2")),
                                      ("inception_v3", ("AuxLogits",))])
def test_checkpoint_with_aux_heads_loads(tmp_path, name, aux):
    source = create_model(name, input_size=75, device="cpu", seed=3)
    weights = {k: v.clone() for k, v in source.net.state_dict().items()}
    for head in aux:
        weights[f"{head}.conv.conv.weight"] = torch.zeros(128, 512, 1, 1)
        weights[f"{head}.fc.weight"] = torch.zeros(1000, 768)
    torch.save(weights, tmp_path / "w.pth")
    victim = load_torch_checkpoint(str(tmp_path / "w.pth"), create_model(
        name, input_size=75, device="cpu", seed=4))
    x = torch.rand((1, 75, 75, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(victim(x), source(x))


@pytest.mark.parametrize("name,size", [("googlenet", 32), ("inception_v3", 75),
                                       ("mobilenet_v2", 32)])
def test_fold_matches_the_unfolded_logits(name, size):
    _, pv = zoo_pair(name, size, seed=5)  # BatchNorms random
    x = torch.rand((2, size, size, 3), generator=torch.Generator().manual_seed(0))
    want = pv(x)
    unfolded = {k: v.clone() for k, v in pv.net.state_dict().items()}
    folded = fold_victim(pv)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    np.testing.assert_allclose(folded(x).numpy(), want.numpy(), atol=1e-5, rtol=0)
    built = create_model(name, input_size=size, device="cpu", state_dict=unfolded, fold_bn=True)
    np.testing.assert_array_equal(built(x).numpy(), folded(x).numpy())


@pytest.mark.parametrize("name", ["densenet121", "vgg11", "vit_tiny"])
def test_fold_is_refused_where_there_is_no_folded_form(name):
    with pytest.raises(ValueError, match="no folded form"):
        create_model(name, input_size=32, device="cpu", fold_bn=True)
    with pytest.raises(ValueError, match="no folded form"):
        fold_victim(create_model(name, input_size=32, device="cpu"))
