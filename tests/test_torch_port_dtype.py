"""bf16 victims, ``create_model(..., dtype=torch.bfloat16)``, against the
JAX package's ``dtype=jnp.bfloat16`` victims on the same weights (drawn in
numpy for the JAX modules' shapes, ``test_torch_port_zoo``): the tiny CNN,
ResNet-18, a narrow DenseNet, GoogLeNet and a ResNet-18 with the S2D stem
and folded BatchNorms here; Inception-v3, MobileNetV2, VGG-11 and ViT-tiny
in ``test_torch_port_dtype_zoo``. Then one ``gd`` step and one DDrague
solve on a bf16 ResNet-18, and the ``ADIL`` class on a bf16 victim.

The gap rule. bf16 rounding moves a random victim's logits by a few 1e-3
and its input gradient by 10-40% (relative l2), so no fixed tolerance
separates a port fault from rounding. Each check is held to the JAX
package's own bf16-vs-fp32 gap on the same inputs: the port's bf16 result
may be no further from the JAX bf16 result than the JAX bf16 result is
from the JAX fp32 one (ratio at most 1), with argmax equal and bf16
logits. The JAX bf16 side is compiled with XLA's excess precision off
(``_torch_port.strict_jit``), so that it rounds where its code rounds, as
torch does op by op: by default XLA keeps fp32 between the casts, and the
JAX victim's default jit is then as far from its own strict rounding as
bf16 is from fp32. Each test prints its ratios. Where the port rounds at
the same points, what is left is fp32 summation order flipping a bf16
rounding, which deep nets carry forward; the ratios printed stay under 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.models.densenet import DenseNet as JaxDenseNet
from dl_attack_on_imagenet_tpu.models.fold import fold_victim as jax_fold_victim
from dl_attack_on_imagenet_tpu.ops import attack_loss as jax_attack_loss
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.models import VictimModel, blocked_twin, create_model
from dl_attack_on_imagenet_tpu_torch.models.convert import (state_dict_from_flax,
                                                            train_state_from_jax)
from dl_attack_on_imagenet_tpu_torch.models.densenet import DenseNet
from dl_attack_on_imagenet_tpu_torch.ops import attack_loss
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import rel_l2, strict_jit, t
from test_torch_port_zoo import MEAN, STD, _images, _variables

N = 4
LABELS = np.asarray([1, 3, 5, 7])


def jax_pair(name: str, size: int, seed: int = 0, fold: bool = False, **kwargs):
    """(fp32 JAX victim, bf16 JAX victim, numpy variables) of registry
    ``name``; ``fold`` folds both, as ``bench.py``'s ``fold_bn=True``."""
    variables = _variables(JAX_REGISTRY[name][0](**kwargs), size, seed)
    victims = [jax_create_model(name, input_size=size, variables=variables, dtype=dt, **kwargs)
               for dt in (jnp.float32, jnp.bfloat16)]
    if fold:
        victims = [jax_fold_victim(v) for v in victims]
    return victims[0], victims[1], variables


def bf16_ratios(jax32, jax16, port16, x: np.ndarray, labels: np.ndarray = LABELS):
    """The gap rule's figures for one victim on ``x``: the relative l2
    distances of the port's bf16 logits and CW-loss input gradient from
    the JAX bf16 ones, each over the JAX bf16-vs-fp32 distance."""
    labels = labels[:len(x)]

    def logits_and_grad(fn):
        def both(xx):
            loss = lambda v: jax_attack_loss(fn(v).astype(jnp.float32), jnp.asarray(labels),  # noqa: E731
                                             loss="logits")
            return fn(xx).astype(jnp.float32), jax.grad(loss)(xx)
        return [np.asarray(a) for a in strict_jit(both, jnp.asarray(x))(jnp.asarray(x))]

    l32, g32 = logits_and_grad(jax32)
    l16, g16 = logits_and_grad(jax16)
    xt = t(x).requires_grad_(True)
    logits = port16(xt)
    (grad,) = torch.autograd.grad(attack_loss(logits.float(), torch.as_tensor(labels),
                                              loss="logits"), xt)
    lp = logits.detach().float().numpy()
    out = dict(dtype=logits.dtype, gap_logits=rel_l2(l16, l32), gap_grad=rel_l2(g16, g32),
               argmax_equal=bool(np.array_equal(lp.argmax(-1), l16.argmax(-1))))
    out["logits"] = rel_l2(lp, l16) / out["gap_logits"]
    out["grad"] = rel_l2(grad.numpy(), g16) / out["gap_grad"]
    return out


def assert_gap_rule(r, name):
    print(f"{name}: JAX bf16-vs-fp32 gap logits {r['gap_logits']:.2e} grad {r['gap_grad']:.3f}; "
          f"port-vs-JAX bf16 over that gap: logits {r['logits']:.3f} grad {r['grad']:.3f}")
    assert r["dtype"] == torch.bfloat16 and r["argmax_equal"]
    assert r["logits"] <= 1.0 and r["grad"] <= 1.0


def _port16(name, size, variables, **kwargs):
    return create_model(name, input_size=size, state_dict=state_dict_from_flax(variables),
                        device="cpu", dtype=torch.bfloat16, **kwargs)


@pytest.mark.parametrize("name,size", [("tiny", 32), ("resnet18", 32), ("googlenet", 32)])
def test_bf16_victim_matches_jax_within_its_gap(name, size):
    jax32, jax16, variables = jax_pair(name, size)
    r = bf16_ratios(jax32, jax16, _port16(name, size, variables), _images(size, n=N))
    assert_gap_rule(r, name)


def test_bf16_narrow_densenet_matches_jax_within_its_gap():
    kw = dict(block_config=(2, 2), growth_rate=8, num_init_features=16, num_classes=10)
    variables = _variables(JaxDenseNet(**kw), 32, seed=0)

    def jax_apply(dtype):
        module = JaxDenseNet(dtype=dtype, **kw)
        return lambda xx: module.apply(variables, (xx - MEAN) / STD)

    net = DenseNet(dtype=torch.bfloat16, **kw)
    net.load_state_dict(state_dict_from_flax(variables))
    port16 = VictimModel("densenet", net.to(memory_format=torch.channels_last), 32,
                         dtype=torch.bfloat16).eval().requires_grad_(False)
    r = bf16_ratios(jax_apply(jnp.float32), jax_apply(jnp.bfloat16), port16,
                    _images(32, n=N), LABELS % 10)
    assert_gap_rule(r, "densenet (2, 2)")


def test_bf16_s2d_folded_resnet_matches_jax_within_its_gap():
    # bench.py's victim: bf16, the S2D stem, BatchNorms folded in fp32 and
    # the folded kernels and biases cast at each convolution.
    jax32, jax16, variables = jax_pair("resnet18", 32, fold=True, stem_s2d=True)
    port16 = _port16("resnet18", 32, variables, stem_s2d=True, fold_bn=True)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in port16.modules())
    r = bf16_ratios(jax32, jax16, port16, _images(32, n=N))
    assert_gap_rule(r, "resnet18 s2d folded")
    assert blocked_twin(port16).dtype == torch.bfloat16


# -- the attack core on a bf16 victim ----------------------------------------

K, SIZE = 8, 32


@pytest.fixture(scope="module")
def resnet16():
    jax32, jax16, variables = jax_pair("resnet18", SIZE, seed=1)
    x = _images(SIZE, n=N, seed=2)
    labels = np.asarray(jnp.argmax(jax32(jnp.asarray(x)), -1), np.int64)
    return jax32, jax16, variables, _port16("resnet18", SIZE, variables), x, labels


def _cfgs(**kw):
    kw = dict(n_atoms=K, batch_size=N, loss="logits", **kw)
    return jcore.AdilConfig(**kw), core.AdilConfig(**kw)


class _KernelDtypes:
    """Wraps the attack core's two kernel wrappers to record the dtypes
    they are handed."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("fused_perturb", "fused_adamw_project"):
            real = getattr(core, name)
            monkeypatch.setattr(core, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def wrapper(*args, **kwargs):
            self.seen.append((name, {a.dtype for a in args if isinstance(a, torch.Tensor)}))
            return real(*args, **kwargs)
        return wrapper


def test_bf16_gd_step_matches_jax_within_its_gap(resnet16, monkeypatch):
    jax32, jax16, variables, port16, x, labels = resnet16
    jcfg, cfg = _cfgs()
    jstate = jcore.init_state(jax.random.PRNGKey(3), (SIZE, SIZE, 3), N, jcfg, mode="gd")
    idx, mask = jnp.arange(N), jnp.ones(N, jnp.float32)
    args = (jstate, variables, jnp.asarray(x), jnp.asarray(labels), idx, mask)
    moved = {}
    for tag, victim in (("32", jax32), ("16", jax16)):
        step = strict_jit(jcore.make_train_step(victim.apply_fn, jcfg, "both"), *args)
        out, loss, _ = step(*args)
        moved[tag] = (np.asarray(out.d) - np.asarray(jstate.d),
                      np.asarray(out.v) - np.asarray(jstate.v), float(loss))
    kernels = _KernelDtypes(monkeypatch)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    d0, v0 = state.d.clone(), state.v.clone()
    loss, _ = core.make_train_step(port16, cfg, "both")(
        state, t(x), torch.as_tensor(labels), torch.arange(N), torch.ones(N))
    assert sorted(n for n, _ in kernels.seen) == ["fused_adamw_project"] * 2
    assert all(dts == {torch.float32} for _, dts in kernels.seen)
    for i, part in enumerate(("D", "v")):
        got = (state.d - d0, state.v - v0)[i].reshape(moved["16"][i].shape).numpy()
        gap = rel_l2(moved["16"][i], moved["32"][i])
        ratio = rel_l2(got, moved["16"][i]) / gap
        print(f"gd step {part} move: JAX bf16-vs-fp32 gap {gap:.3e}, port over gap {ratio:.3f}")
        assert ratio <= 1.0
    loss_gap = abs(moved["16"][2] - moved["32"][2])
    print(f"gd step loss: gap {loss_gap:.3e}, port {abs(float(loss) - moved['16'][2]):.3e}")
    assert abs(float(loss) - moved["16"][2]) <= loss_gap


def test_bf16_ddrague_matches_jax_within_its_gap(resnet16, monkeypatch):
    jax32, jax16, variables, port16, x, _ = resnet16
    jcfg, cfg = _cfgs(steps_inference=3, eps=0.1)
    d = np.random.RandomState(4).uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    moves = {}
    for tag, victim in (("32", jax32), ("16", jax16)):
        solve = functools.partial(jcore.supervised_ddrague, victim.apply_fn, cfg=jcfg)
        adv = strict_jit(solve, variables, jnp.asarray(d), jnp.asarray(x))(
            variables, jnp.asarray(d), jnp.asarray(x))
        moves[tag] = np.asarray(adv) - x
    kernels = _KernelDtypes(monkeypatch)
    got = core.supervised_ddrague(port16, t(d), t(x), cfg).numpy() - x
    assert kernels.seen == [("fused_perturb", {torch.float32})]
    gap = rel_l2(moves["16"], moves["32"])
    ratio = rel_l2(got, moves["16"]) / gap
    print(f"DDrague adversary move: JAX bf16-vs-fp32 gap {gap:.3e}, port over gap {ratio:.3f}")
    assert ratio <= 1.0


@pytest.mark.parametrize("perturb_dtype", ["float32", "bfloat16"])
def test_adil_learns_serves_and_shares_its_artifact_with_jax(resnet16, perturb_dtype,
                                                             tmp_path, monkeypatch):
    _, jax16, _, port16, x, labels = resnet16
    kw = dict(n_atoms=K, steps=2, batch_size=N, loss="logits", steps_inference=2,
              perturb_dtype=perturb_dtype)
    kernels = _KernelDtypes(monkeypatch)
    attack = ADIL(port16, cache=ArtifactCache(str(tmp_path)), model_name="r18", **kw)
    attack.learn_dictionary((x, labels))
    adv = attack(t(x), torch.as_tensor(labels))
    assert adv.dtype == torch.float32 and adv.shape == x.shape
    assert bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0 and float(adv.max()) <= 1
    assert {n for n, _ in kernels.seen} == {"fused_perturb", "fused_adamw_project"}
    assert all(dts == {torch.float32} for _, dts in kernels.seen)
    jattack = JaxADIL(jax16, cache=JaxArtifactCache(str(tmp_path)), model_name="r18", **kw)
    assert jattack.is_trained
    np.testing.assert_array_equal(np.asarray(jattack._load_dictionary()),
                                  attack.dictionary.numpy())
    jadv = np.asarray(jattack(jnp.asarray(x), jnp.asarray(labels)))
    assert jadv.shape == x.shape and np.isfinite(jadv).all()
