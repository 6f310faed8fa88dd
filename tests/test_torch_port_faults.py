"""Two places where the port and the JAX package part in float32, each
traced to its cause in float64.

a. DDrague on a random ResNet-18 at 32x32 (the S2D victim of
   ``test_torch_port_adil_s2d_pipeline``, served in the standard layout).
   After 5 steps the packages were up to 7.4e-4 apart, in one image. In
   float64 the two agree to 1e-8 (2e-16 measured) at every step count, and
   the JAX package's float32 run stays within 1e-6 of its float64 one; the port's
   float32 run parts from its own float64 run in that image alone. The
   cause is a ReLU whose input lies on the float32 noise floor: in the
   port's float32 forward one unit of ``layer3.0`` reads -3.8e-7 where
   float64 reads +7.6e-7, so it passes no gradient, and that image's input
   gradient moves by up to 0.06 (0.4% of its largest entry). DDrague's
   normalized AdamW steps carry that into the adversary. This is float32
   rounding meeting a ReLU's kink, not a port fault, and no tolerance
   hides it: the images without such a unit agree to 1e-5, and the one
   with it to 1e-3.

b. APGD-DLR where the true class ranks third. DLR is then
   ``(z1 - z3) / (z1 - z3 + 1e-12)``, exactly 1 in float32, where APGD
   computes its losses; its gradient cancels to rounding, 0 in the port
   and 1 ulp in the JAX package's autodiff on some rows. APGD's l∞ step
   takes the sign of the input gradient, so a row at the tie takes a full
   step in one package and none in the other. Up to the iterate at which a
   row first reaches the tie, the two packages agree in float64 (the JAX
   package under x64 and a float64 copy of the port's net); after it they
   part on that row, and only there.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import apgd as japgd
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.attacks import apgd
from dl_attack_on_imagenet_tpu_torch.models.layers import IMAGENET_MEAN, IMAGENET_STD, ReLU

from _torch_port import call_key, victim_pair
from test_torch_port_zoo import zoo_pair

# -- a. DDrague on a random ResNet-18 -----------------------------------------

K, SIZE, N = 4, 32, 4


class _Net64(torch.nn.Module):
    """A float64 copy of a port victim's net behind its NHWC interface, with
    the normalization's constants in float64, as JAX's are under x64."""

    def __init__(self, pv):
        super().__init__()
        self.net = copy.deepcopy(pv.net).double()
        self.mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64).reshape(1, 3, 1, 1)
        self.std = torch.tensor(IMAGENET_STD, dtype=torch.float64).reshape(1, 3, 1, 1)

    def forward(self, z):
        return self.net((z.permute(0, 3, 1, 2).double() - self.mean) / self.std)


@pytest.fixture(scope="module")
def resnet():
    jv, pv = zoo_pair("resnet18", SIZE, seed=2, stem_s2d=True)
    x = np.random.RandomState(3).uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    d = np.random.RandomState(4).uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    return jv, pv, x, d


def _cfgs(steps):
    kw = dict(n_atoms=K, loss="logits", steps_inference=steps, eps=0.1)
    return jcore.AdilConfig(**kw), core.AdilConfig(**kw)


@pytest.mark.parametrize("steps", [1, 5])
def test_ddrague_agrees_with_jax_in_float64(resnet, steps):
    jv, pv, x, d = resnet
    jcfg, cfg = _cfgs(steps)
    with jax.enable_x64(True):
        vars64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv.variables)
        jv64 = jax_create_model("resnet18", input_size=SIZE, dtype=jnp.float64,
                                variables=vars64, stem_s2d=True)
        want = np.asarray(jcore.supervised_ddrague(jv64.apply_fn, vars64,
                                                   jnp.asarray(d, jnp.float64),
                                                   jnp.asarray(x, jnp.float64), jcfg))
    got = core.supervised_ddrague(_Net64(pv), torch.tensor(d, dtype=torch.float64),
                                  torch.tensor(x, dtype=torch.float64), cfg)
    assert got.dtype == torch.float64
    assert float(np.abs(got.numpy() - want).max()) <= 1e-8
    # The JAX package's float32 run is within 1e-6 of this.
    jax32 = np.asarray(jcore.supervised_ddrague(jv.apply_fn, jv.variables, jnp.asarray(d),
                                                jnp.asarray(x), jcfg))
    assert float(np.abs(jax32 - want).max()) <= 1e-6


def _relu_inputs(net, x):
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append(inp[0].double()))
             for m in net.modules() if isinstance(m, ReLU)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_the_port_parts_only_where_a_relu_input_is_on_the_fp32_noise_floor(resnet):
    _, pv, x, _ = resnet
    net64 = _Net64(pv)
    xt = torch.tensor(x)
    grads = []
    for model, xx in ((pv, xt.clone()), (net64, xt.double())):
        xx.requires_grad_(True)
        (g,) = torch.autograd.grad(model(xx).sum(), xx)
        grads.append(g.double())
    err = (grads[0] - grads[1]).abs().amax(dim=(1, 2, 3))
    # Which images hold a ReLU whose input has another sign in float64, and
    # how close to zero those inputs are.
    flipped = torch.zeros(N, dtype=torch.bool)
    for a, b in zip(_relu_inputs(pv, xt), _relu_inputs(net64, xt.double())):
        flip = (a > 0) != (b > 0)
        if flip.any():
            assert float(a[flip].abs().max()) < 1e-5 and float(b[flip].abs().max()) < 1e-5
            flipped |= flip.flatten(1).any(dim=1)
    print(f"input gradient, fp32 against fp64 per image: {err.tolist()}; "
          f"images with a ReLU on the noise floor: {flipped.tolist()}")
    assert bool((err[~flipped] < 1e-4).all())
    assert bool((err[flipped] > 1e-3).all())


def test_standard_layout_ddrague_stays_within_an_absolute_bound_of_jax(resnet):
    jv, pv, x, d = resnet
    jcfg, cfg = _cfgs(5)
    want = np.asarray(jcore.supervised_ddrague(jv.apply_fn, jv.variables, jnp.asarray(d),
                                               jnp.asarray(x), jcfg))
    got = core.supervised_ddrague(pv, torch.tensor(d), torch.tensor(x), cfg).numpy()
    per_image = np.abs(got - want).reshape(N, -1).max(axis=1)
    print(f"DDrague after 5 steps, port against JAX per image: {per_image.tolist()}")
    # At most one image of this batch holds a ReLU on the noise floor
    # (the test above); the others agree as the tiny victim does.
    assert float(per_image.max()) <= 1e-3
    assert int((per_image > 1e-5).sum()) <= 1


# -- b. APGD-DLR at the tie ---------------------------------------------------

STEPS, RESTARTS, EPS = 5, 4, 8 / 255


@pytest.fixture(scope="module")
def tiny():
    jv, _, pv = victim_pair("tiny", key=21)
    x = np.random.RandomState(3).uniform(0.0, 1.0, (8, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jv.predict(jnp.asarray(x))).astype(np.int64)
    return jv, pv, x, labels


def test_dlr_is_exactly_one_where_the_true_class_ranks_third(tiny):
    jv, pv, x, _ = tiny
    logits = np.asarray(jv(jnp.asarray(x)))
    third = np.argsort(-logits, axis=1, kind="stable")[:, 2]
    jl, jvjp = jax.vjp(lambda z: japgd._per_image_loss(z, jnp.asarray(third), jnp.asarray(third),
                                                     "dlr"), jnp.asarray(logits))
    (jg,) = jvjp(jnp.ones(len(x)))
    zt = torch.tensor(logits, requires_grad=True)
    pl = apgd._per_image_loss(zt, torch.tensor(third), torch.tensor(third), "dlr")
    (pg,) = torch.autograd.grad(pl.sum(), zt)
    np.testing.assert_array_equal(np.asarray(jl), 1.0)
    np.testing.assert_array_equal(pl.detach().numpy(), 1.0)
    # The gradient cancels: at most a few ulps of 1 / (z1 - z3) are left.
    scale = 1.0 / (np.sort(logits, 1)[:, -1] - np.sort(logits, 1)[:, -3])
    assert float(np.abs(np.asarray(jg)).max(1).max() / scale.min()) < 1e-6
    assert float(pg.abs().max(1).values.max() / scale.min()) < 1e-6


class _Victim64(torch.nn.Module):
    """The tiny port victim in float64 (it has no normalization)."""

    def __init__(self, pv):
        super().__init__()
        self.net = copy.deepcopy(pv.net).double()

    def forward(self, z):
        return self.net(z.permute(0, 3, 1, 2).double())


def test_apgd_dlr_matches_jax_in_float64_until_a_row_reaches_the_tie(tiny, monkeypatch):
    jv, pv, x, labels = tiny
    jlosses, plosses = [], []
    real_j, real_p = japgd._per_image_loss, apgd._per_image_loss

    def j_recorded(logits, labels_, targets, loss):
        per = real_j(logits, labels_, targets, loss)
        jax.debug.callback(lambda v: jlosses.append(np.asarray(v)), per, ordered=True)
        return per

    def p_recorded(logits, labels_, targets, loss):
        per = real_p(logits, labels_, targets, loss)
        plosses.append(per.detach().numpy())
        return per

    monkeypatch.setattr(japgd, "_per_image_loss", j_recorded)
    monkeypatch.setattr(apgd, "_per_image_loss", p_recorded)
    ties = 0
    with jax.enable_x64(True):
        vars64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv.variables)
        jv64 = jax_create_model("tiny", dtype=jnp.float64, variables=vars64)
        for r in range(RESTARTS):
            key = jax.random.fold_in(call_key(0), r)
            del jlosses[:], plosses[:]
            want, _ = japgd.apgd(jv64.apply_fn, vars64, jnp.asarray(x, jnp.float64),
                                 jnp.asarray(labels), EPS, STEPS, loss="dlr", key=key)
            jax.effects_barrier()
            u = torch.tensor(np.asarray(2.0 * jax.random.uniform(key, x.shape) - 1.0))
            got, _ = apgd.apgd(_Victim64(pv), torch.tensor(x, dtype=torch.float64),
                               torch.tensor(labels), EPS, STEPS, loss="dlr", u=u)
            jl, pl = np.stack(jlosses), np.stack(plosses)  # (STEPS + 1, n): x0, then each step
            assert jl.shape == pl.shape == (STEPS + 1, len(x))
            at_tie = (jl == 1.0) | (pl == 1.0)
            for i in range(len(x)):
                first = int(np.argmax(at_tie[:, i])) if at_tie[:, i].any() else STEPS
                # Every loss up to and at the row's first tie agrees ...
                np.testing.assert_allclose(pl[:first + 1, i], jl[:first + 1, i],
                                           atol=1e-6, rtol=0)
                if not at_tie[:, i].any():  # ... and a row that never reaches it ends equal.
                    err = float(np.abs(got[i].numpy() - np.asarray(want[i])).max())
                    assert err <= 1e-12
            ties += int(at_tie.any(axis=0).sum())
    assert ties >= 1  # the grid's inputs reach the tie
