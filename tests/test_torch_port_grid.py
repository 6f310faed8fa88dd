"""The port's gradient baselines of the torchattacks grid against the JAX
package's, on the tiny victim at 32x32 with the same weights
(``victim_pair``) and inputs drawn in numpy from fixed seeds: the DLR
losses, FGSM/PGD/BIM (``attacks/pgd.py``), the FGSM family
(``attacks/fgsm_family.py``) and CW (``attacks/cw.py``). Every random draw
is JAX's own, rebuilt from the key chain the JAX package folds, and passed
to the port.

Tolerances: the losses and their gradients, and ``input_diversity`` with
its VJP, within 1e-6; l2 trajectories and CW within 1e-5. Signed-step l∞
trajectories within the bound of ``tests/test_torch_parity_uap.py``: atol
2e-3 with under 1% of the elements beyond 5e-5, since a gradient element at
the noise floor can flip its sign; the port meets 1e-5 on these inputs,
which the tests record.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import attacks as jattacks
from dl_attack_on_imagenet_tpu.attacks import cw as jcw
from dl_attack_on_imagenet_tpu.attacks import fgsm_family as jfam
from dl_attack_on_imagenet_tpu.attacks import pgd as jpgd
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.ops import dlr_loss as jax_dlr_loss
from dl_attack_on_imagenet_tpu.ops import dlr_loss_targeted as jax_dlr_loss_targeted
from dl_attack_on_imagenet_tpu_torch import attacks
from dl_attack_on_imagenet_tpu_torch.attacks import cw, fgsm_family, pgd
from dl_attack_on_imagenet_tpu_torch.ops import dlr_loss, dlr_loss_targeted

from _torch_port import assert_signed_close, call_key, max_err, t, victim_pair

SIZE, N = 32, 8
EPS, ALPHA = 8 / 255, 2 / 255
STEPS = 4


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny", key=21)
    rs = np.random.RandomState(3)
    images = rs.uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jv.predict(jnp.asarray(images))).astype(np.int64)
    return jv, variables, pv, images, labels





def _assert_share_close(got, want):
    """TPGD's bound: under 1% of the elements beyond 5e-5 (see
    :func:`test_tpgd_flips_only_noise_floor_signs_in_float64`)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert float((diff > 5e-5).mean()) < 0.01


def test_exports_match_the_jax_package():
    assert attacks.__all__ == jattacks.__all__


# -- the DLR losses -----------------------------------------------------------


@pytest.mark.parametrize("targeted", [False, True])
def test_dlr_losses_and_gradients_match_jax(targeted):
    rs = np.random.RandomState(0)
    logits = rs.normal(size=(6, 10)).astype(np.float32)
    logits[1, 3] = logits[1, 7] = logits[1].max() + 1.0  # a tie at the top
    logits[2, :] = 0.5  # every logit tied
    labels = np.array([0, 3, 2, 9, 4, 5])
    targets = np.array([1, 7, 3, 0, 9, 5])
    if targeted:
        def jax_fn(z):
            return jnp.sum(jax_dlr_loss_targeted(z, jnp.asarray(labels), jnp.asarray(targets)))

        def port_fn(z):
            return torch.sum(dlr_loss_targeted(z, torch.tensor(labels), torch.tensor(targets)))
    else:
        def jax_fn(z):
            return jnp.sum(jax_dlr_loss(z, jnp.asarray(labels)))

        def port_fn(z):
            return torch.sum(dlr_loss(z, torch.tensor(labels)))
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    z = t(logits).requires_grad_(True)
    got = port_fn(z)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    assert max_err(z.grad, want_grad) <= 1e-6


# -- FGSM, PGD, BIM -------------------------------------------------------------


@pytest.mark.parametrize("targeted", [False, True])
def test_fgsm_matches_jax(setup, targeted):
    jv, variables, pv, x, y = setup
    want = jpgd.fgsm(jv.apply_fn, variables, jnp.asarray(x), jnp.asarray(y), EPS, targeted)
    got = pgd.fgsm(pv, t(x), torch.tensor(y), EPS, targeted)
    assert_signed_close(got, want)


def _pgd_start(norm, shape, key, eps=EPS):
    """JAX's PGD start from ``key``, as ``attacks/pgd.py`` draws it."""
    if norm == "linf":
        return t(np.asarray(jax.random.uniform(key, shape, minval=-eps, maxval=eps)))
    d = jax.random.normal(key, shape)
    nrm = jnp.sqrt(jnp.sum(d ** 2, axis=(1, 2, 3), keepdims=True))
    return t(np.asarray(d / jnp.maximum(nrm, 1e-12) * eps))


@pytest.mark.parametrize("norm,alpha,random_start,targeted", [
    ("linf", ALPHA, True, False), ("linf", ALPHA, False, False), ("linf", ALPHA, True, True),
    ("l2", 0.1, True, False), ("l2", 0.1, True, True)])
def test_pgd_matches_jax(setup, norm, alpha, random_start, targeted):
    jv, variables, pv, x, y = setup
    eps = EPS if norm == "linf" else 0.5
    key = call_key(5)
    want = jpgd._pgd_cache(jv.apply_fn, STEPS, norm, random_start, targeted)(
        variables, jnp.asarray(x), jnp.asarray(y), key, eps, alpha)
    delta0 = _pgd_start(norm, x.shape, key, eps) if random_start else None
    got = pgd.pgd(pv, t(x), torch.tensor(y), eps, alpha, STEPS, norm=norm,
                  random_start=random_start, targeted=targeted, delta0=delta0)
    if norm == "l2":
        assert max_err(got, want) <= 1e-5
    else:
        assert_signed_close(got, want)


def test_pgd_needs_its_start():
    with pytest.raises(ValueError, match="delta0"):
        pgd.pgd(None, torch.zeros(1, 4, 4, 3), torch.zeros(1, dtype=torch.long), EPS, ALPHA, 1)


# -- the FGSM family -------------------------------------------------------------


@pytest.mark.parametrize("rnd,pad_top,pad_left,use", [
    (28, 0, 3, True), (30, 1, 0, True), (29, 2, 2, True), (31, 0, 0, True), (29, 1, 2, False)])
def test_input_diversity_matches_jax_value_and_vjp(rnd, pad_top, pad_left, use):
    rs = np.random.RandomState(rnd)
    x = rs.uniform(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    cot = rs.normal(size=x.shape).astype(np.float32)

    def jax_fn(z):
        scale = jnp.float32(rnd) / SIZE
        out = jax.image.scale_and_translate(
            z, z.shape, (1, 2), jnp.stack([scale, scale]),
            jnp.asarray([pad_top, pad_left], jnp.float32), method="linear", antialias=False)
        return jnp.where(use, out, z)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    z = t(x).requires_grad_(True)
    got = fgsm_family.input_diversity(z, rnd, pad_top, pad_left, use)
    got.backward(t(cot))
    assert max_err(got.detach(), want) <= 1e-6
    assert max_err(z.grad, vjp(jnp.asarray(cot))[0]) <= 1e-6
    if use:  # the zero pad around the resized image
        pad = np.ones(x.shape, bool)
        pad[:, pad_top:pad_top + rnd, pad_left:pad_left + rnd] = False
        assert not got.detach().numpy()[pad].any()


def _diversity(key, steps, resize_low, prob):
    """DIFGSM's per-step draws, as ``fgsm_family.input_diversity`` makes
    them from ``fold_in(key, i)``."""
    out = []
    for i in range(steps):
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(key, i), 4)
        rnd = int(jax.random.randint(k1, (), resize_low, SIZE))
        rem = SIZE - rnd
        out.append((rnd, int(jax.random.randint(k2, (), 0, rem)),
                    int(jax.random.randint(k3, (), 0, rem)),
                    bool(jax.random.uniform(k4, ()) < prob)))
    return out


def _family_pair(name, jv, variables, pv, x, y, key, targeted=False):
    """(JAX result, port result) of the FGSM-family core ``name`` on the
    draws of ``key``."""
    jx, jy, px, py = jnp.asarray(x), jnp.asarray(y), t(x), torch.tensor(y)
    normal = t(np.asarray(jax.random.normal(key, x.shape)))
    uniform = t(np.asarray(jax.random.uniform(key, x.shape, minval=-EPS, maxval=EPS)))
    if name == "gn":
        return jfam.gn(jx, 0.1, key), fgsm_family.gn(px, 0.1, normal)
    if name == "rfgsm":
        return (jfam.rfgsm(jv.apply_fn, variables, jx, jy, EPS, ALPHA, STEPS, targeted, key),
                fgsm_family.rfgsm(pv, px, py, EPS, ALPHA, STEPS, normal, targeted))
    if name == "ffgsm":
        return (jfam.ffgsm(jv.apply_fn, variables, jx, jy, EPS, 10 / 255, targeted, key),
                fgsm_family.ffgsm(pv, px, py, EPS, 10 / 255, uniform, targeted))
    if name == "mifgsm":
        return (jfam.mifgsm(jv.apply_fn, variables, jx, jy, EPS, ALPHA, 0.5, STEPS, targeted),
                fgsm_family.mifgsm(pv, px, py, EPS, ALPHA, 0.5, STEPS, targeted))
    if name == "tpgd":
        return (jfam.tpgd(jv.apply_fn, variables, jx, EPS, ALPHA, STEPS, key),
                fgsm_family.tpgd(pv, px, EPS, ALPHA, STEPS, normal))
    if name == "eotpgd":
        return (jfam.eotpgd(jv.apply_fn, variables, jx, jy, EPS, ALPHA, STEPS, 2, True,
                            targeted, key),
                fgsm_family.eotpgd(pv, px, py, EPS, ALPHA, STEPS, 2, True, targeted, uniform))
    if name == "difgsm":
        k0, k_steps = jax.random.split(key)
        delta0 = t(np.asarray(jax.random.uniform(k0, x.shape, minval=-EPS, maxval=EPS)))
        draws = _diversity(k_steps, STEPS, int(SIZE * 0.9), 0.5)
        assert {d[3] for d in draws} == {True, False}  # both branches run
        return (jfam.difgsm(jv.apply_fn, variables, jx, jy, EPS, ALPHA, 0.5, 0.5, STEPS,
                            0.9, True, targeted, key),
                fgsm_family.difgsm(pv, px, py, EPS, ALPHA, 0.5, STEPS, draws, True, targeted,
                                   delta0))
    raise ValueError(name)


@pytest.mark.parametrize("name,targeted", [
    ("gn", False), ("rfgsm", False), ("rfgsm", True), ("ffgsm", False), ("ffgsm", True),
    ("mifgsm", False), ("mifgsm", True), ("tpgd", False), ("eotpgd", False),
    ("eotpgd", True), ("difgsm", False), ("difgsm", True)])
def test_fgsm_family_core_matches_jax(setup, name, targeted):
    jv, variables, pv, x, y = setup
    # Key 2: DIFGSM's draws take both branches of input_diversity.
    want, got = _family_pair(name, jv, variables, pv, x, y, call_key(2), targeted)
    if name == "gn":
        assert max_err(got, want) <= 1e-6
    elif name == "tpgd":
        _assert_share_close(got, want)
    else:
        assert_signed_close(got, want)


@pytest.fixture(scope="module")
def f64(setup):
    """Both victims in float64 with one set of weights: the JAX one under
    ``enable_x64``, the port's a ``.double()`` copy of its net
    (``VictimModel`` casts to fp32) that promotes its input to float64, as
    a float64 Flax layer promotes a float32 one."""
    jv, _, pv, _, _ = setup
    with jax.enable_x64(True):
        vars64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv.variables)
        jv64 = jax_create_model("tiny", dtype=jnp.float64, variables=vars64)
    net = copy.deepcopy(pv.net).double()

    def port_apply(z):
        return net(z.permute(0, 3, 1, 2).double())

    return jv64, vars64, port_apply


def test_tpgd_flips_only_noise_floor_signs_in_float64(setup, f64):
    # TPGD ascends KL(p_clean || p_adv) from x + 0.001 N(0, 1), where the
    # softmaxes differ by about 1e-5: the JAX package takes them in float32
    # (it casts the logits, under x64 too), so an input-gradient element
    # below about 1e-3 of the largest takes its sign from float32 rounding.
    # After one step every element that differs is such an element, and
    # the others agree within 1e-5; after four, under 1% differ.
    jv64, vars64, port_apply = f64
    *_, x, _ = setup
    key = call_key(2)
    with jax.enable_x64(True):
        x64 = jnp.asarray(x, jnp.float64)
        noise = jax.random.normal(key, x.shape)
        logit_ori = jv64.apply_fn(vars64, x64).astype(jnp.float32)
        p_ori, logp_ori = jax.nn.softmax(logit_ori), jax.nn.log_softmax(logit_ori)

        def kl(adv):
            logp = jax.nn.log_softmax(jv64.apply_fn(vars64, adv).astype(jnp.float32))
            return jnp.sum(p_ori * (logp_ori - logp))

        g = np.abs(np.asarray(jax.grad(kl)(x64 + 0.001 * noise)))
        want = {steps: np.asarray(jfam.tpgd(jv64.apply_fn, vars64, x64, EPS, ALPHA, steps, key))
                for steps in (1, STEPS)}
    got = {steps: fgsm_family.tpgd(port_apply, torch.tensor(x, dtype=torch.float64), EPS,
                                   ALPHA, steps, torch.tensor(np.asarray(noise))).numpy()
           for steps in (1, STEPS)}
    differ = np.abs(got[1] - want[1]) > 5e-5
    assert float(g[differ].max(initial=0.0)) <= 1e-3 * float(g.max())
    assert max_err(got[1][~differ], want[1][~differ]) <= 1e-5
    _assert_share_close(got[STEPS], want[STEPS])


def test_difgsm_checks_its_draws(setup):
    _, _, pv, x, y = setup
    with pytest.raises(ValueError, match="diversity draws"):
        fgsm_family.difgsm(pv, t(x), torch.tensor(y), EPS, ALPHA, 0.0, 2, [(30, 0, 0, True)])


def test_vanila_is_the_identity(setup):
    *_, x, _ = setup
    assert torch.equal(attacks.VANILA(setup[2])(t(x)), t(x))


# -- CW ------------------------------------------------------------------------------


@pytest.mark.parametrize("targeted", [False, True])
def test_cw_matches_jax(setup, targeted):
    jv, variables, pv, x, y = setup
    # Targeted: each image's second most probable class.
    target = np.argsort(np.asarray(jv(jnp.asarray(x))), -1)[:, -2] if targeted else y
    want = jcw._cw_cache(jv.apply_fn, STEPS, targeted)(
        variables, jnp.asarray(x), jnp.asarray(target), 5.0, 0.0, 0.01)
    got = cw.cw_l2(pv, t(x), torch.tensor(target), 5.0, 0.0, 0.01, STEPS, targeted)
    assert max_err(got, want) <= 1e-5
    # Some images fooled (moved) and some not (returned clean), on both sides.
    moved = np.abs(np.asarray(want) - x).reshape(N, -1).max(1) > 0
    assert moved.any() and not moved.all()
    assert np.array_equal(np.abs(got.numpy() - x).reshape(N, -1).max(1) > 0, moved)


# -- the classes on a fresh instance, with the draws of its first call ------------------


def _class_case(name, jv, pv, shape):
    """(JAX instance, port instance, the port's draws of the first call)."""
    key = call_key(0)
    uniform = t(np.asarray(jax.random.uniform(key, shape, minval=-EPS, maxval=EPS)))
    normal = t(np.asarray(jax.random.normal(key, shape)))
    if name == "FGSM":
        return jattacks.FGSM(jv), attacks.FGSM(pv), None
    if name == "PGD":
        return (jattacks.PGD(jv, steps=STEPS), attacks.PGD(pv, steps=STEPS), uniform)
    if name == "PGD-l2":
        return (jattacks.PGD(jv, eps=EPS, alpha=0.05, steps=STEPS, norm="L2"),
                attacks.PGD(pv, eps=EPS, alpha=0.05, steps=STEPS, norm="L2"),
                _pgd_start("l2", shape, key))
    if name == "BIM":
        return jattacks.BIM(jv, steps=STEPS), attacks.BIM(pv, steps=STEPS), None
    if name == "GN":
        return jattacks.GN(jv, sigma=0.05), attacks.GN(pv, sigma=0.05), normal
    if name == "RFGSM":
        return jattacks.RFGSM(jv, steps=STEPS), attacks.RFGSM(pv, steps=STEPS), normal
    if name == "FFGSM":
        return jattacks.FFGSM(jv), attacks.FFGSM(pv), uniform
    if name == "MIFGSM":
        return jattacks.MIFGSM(jv, steps=STEPS), attacks.MIFGSM(pv, steps=STEPS), None
    if name == "TPGD":
        return jattacks.TPGD(jv, steps=STEPS), attacks.TPGD(pv, steps=STEPS), normal
    if name == "EOTPGD":
        return jattacks.EOTPGD(jv, steps=STEPS), attacks.EOTPGD(pv, steps=STEPS), uniform
    if name == "DIFGSM":
        return (jattacks.DIFGSM(jv, steps=STEPS, diversity_prob=0.7),
                attacks.DIFGSM(pv, steps=STEPS, diversity_prob=0.7),
                (None, _diversity(key, STEPS, int(SIZE * 0.9), 0.7)))
    if name == "CW":
        return (jattacks.CW(jv, c=5.0, steps=STEPS), attacks.CW(pv, c=5.0, steps=STEPS), None)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["FGSM", "PGD", "PGD-l2", "BIM", "GN", "RFGSM", "FFGSM",
                                  "MIFGSM", "TPGD", "EOTPGD", "DIFGSM", "CW"])
def test_class_matches_jax(setup, name):
    jv, _, pv, x, y = setup
    j_atk, p_atk, draws = _class_case(name, jv, pv, x.shape)
    want = j_atk(jnp.asarray(x), jnp.asarray(y))
    kwargs = {} if draws is None else {"draws": draws}
    got = p_atk(t(x), torch.tensor(y), **kwargs)
    if name in ("GN", "PGD-l2", "CW"):
        assert max_err(got, want) <= 1e-5
    elif name == "TPGD":
        _assert_share_close(got, want)
    else:
        assert_signed_close(got, want)
    if draws is not None:
        assert p_atk._rng_calls == 1
        # The class's own draws: the same call counter, seeded on the host.
        own = type(p_atk)(pv, **({"steps": STEPS} if hasattr(p_atk, "steps") else {}))
        assert own(t(x), torch.tensor(y)).shape == got.shape


def test_classes_draw_anew_each_call_and_repeat_per_seed(setup):
    _, _, pv, x, y = setup
    first = attacks.PGD(pv, steps=1, seed=3)
    a, b = first(t(x), torch.tensor(y)), first(t(x), torch.tensor(y))
    assert not torch.equal(a, b)
    assert torch.equal(attacks.PGD(pv, steps=1, seed=3)(t(x), torch.tensor(y)), a)
