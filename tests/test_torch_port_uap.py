"""The port's universal baselines (UAP-PGD, DeepFool, DeepFoolCosinus,
Fast-UAP, Moosavi's universal perturbation) against the JAX package's, on
the tiny victim at 32x32 with the same weights (``victim_pair``) and inputs
drawn in numpy from fixed seeds.

Tolerances: projections, folds, the loss and its gradient within 1e-6;
DeepFool's iteration counts exact and its perturbations within 1e-5, and
so Fast-UAP's and the universal perturbation's accept decisions are exact,
their perturbations within 1e-5 and their fooling histories equal; a UAP-PGD
epoch and ``learn_attack`` within 1e-5 in ``e`` under l2. Under l∞ the bound
of ``tests/test_torch_parity_uap.py``: atol 2e-3 with under 1% of the
elements beyond 5e-5, as an element at the clamp's boundary flips its
trajectory on a 1e-7 difference; the port meets 1e-5 there too on these
inputs, which the test records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import evaluation as jev
from dl_attack_on_imagenet_tpu.attacks import FastUAP as JaxFastUAP
from dl_attack_on_imagenet_tpu.attacks import UAPPGD as JaxUAPPGD
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.attacks import deepfool as jdf
from dl_attack_on_imagenet_tpu.attacks import fast_uap as jfast
from dl_attack_on_imagenet_tpu.attacks import uap_pgd as juap
from dl_attack_on_imagenet_tpu.attacks.universal_pert import (
    universal_perturbation as jax_universal_perturbation)
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch import evaluation as ev
from dl_attack_on_imagenet_tpu_torch.attacks import (
    UAPPGD, DeepFool, DeepFoolCosinus, FastUAP, deepfool_batch, universal_perturbation)
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.attacks import deepfool, fast_uap, uap_pgd
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t, victim_pair

SIZE, N = 32, 10
INF = float("inf")


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny", key=7)
    rs = np.random.RandomState(3)
    images = rs.uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jv.predict(jnp.asarray(images))).astype(np.int64)
    return jv, variables, pv, images, labels


def _noise(seed, shape, scale):
    return (np.random.RandomState(seed).normal(0.0, scale, shape)).astype(np.float32)


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def _assert_uap_close(got, want, norm):
    """l2: within 1e-5. l∞: the clamp-boundary bound (see the module)."""
    if norm == "l2":
        assert _max_err(got, want) <= 1e-5
    else:
        diff = np.abs(np.asarray(got) - np.asarray(want))
        assert float(diff.max()) <= 2e-3 and float((diff > 5e-5).mean()) < 0.01
        assert float(diff.max()) <= 1e-5  # what the port meets on these inputs


# -- the pieces --------------------------------------------------------------

@pytest.mark.parametrize("norm,eps", [("l2", 0.1), ("linf", 0.05), ("l2", INF), ("linf", INF)])
def test_project_uap_matches_jax(norm, eps):
    e = _noise(0, (1, SIZE, SIZE, 3), 0.1)
    got = uap_pgd.project_uap(t(e), eps, norm)
    assert _max_err(got, juap.project_uap(jnp.asarray(e), eps, norm)) <= 1e-6
    if eps == INF:
        np.testing.assert_array_equal(got.numpy(), e)


@pytest.mark.parametrize("norm,eps", [("l2", 0.5), ("linf", 0.05), ("linf", INF)])
def test_fold_increments_matches_jax(norm, eps):
    a = _noise(1, (SIZE, SIZE, 3), 0.02)
    deltas = _noise(2, (6, SIZE, SIZE, 3), 0.05)
    accept = np.random.RandomState(3).rand(6) < 0.5
    got = uap_pgd.fold_increments(t(a), t(deltas), torch.tensor(accept), eps, norm)
    want = juap.fold_increments(jnp.asarray(a), jnp.asarray(deltas), jnp.asarray(accept),
                                jnp.float32(eps), norm)
    assert _max_err(got, want) <= 1e-6


@pytest.mark.parametrize("beta", [9.0, 0.01])  # 0.01: the clip binds, the gradient is 0
def test_uap_loss_and_its_gradient_match_jax(setup, beta):
    jv, variables, pv, images, labels = setup
    e = _noise(4, (1, SIZE, SIZE, 3), 0.05)
    mask = np.array([1, 1, 1, 1, 0], np.float32)
    x, y = images[:5], labels[:5]

    def jax_loss(e_):
        return juap.uap_loss(jv.apply_fn, variables, e_, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(mask), beta)

    (jl, jfool), jg = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(e))
    et = t(e).requires_grad_(True)
    loss, fooling = uap_pgd.uap_loss(pv, et, t(x), torch.tensor(y), t(mask), beta)
    (grad,) = torch.autograd.grad(loss, et)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6
    assert float(fooling) == float(jfool)
    assert _max_err(grad, jg) <= 1e-6
    if beta < 1:
        assert float(loss.detach()) == np.float32(-beta) and float(grad.abs().max()) == 0.0


# -- UAP-PGD -------------------------------------------------------------------

def _jax_plans(n, batch, epochs, seed=5):
    key = jax.random.PRNGKey(seed)
    plans = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        plans.append(np.asarray(jcore.make_batches(sub, n, batch)))
    return plans


def _both_uappgd(setup, tmp_path, **kw):
    jv, _, pv, _, _ = setup
    kw = dict(steps=0, beta=9.0, step_size=0.01, **kw)
    return (UAPPGD(pv, cache=ArtifactCache(str(tmp_path / "port")), **kw),
            JaxUAPPGD(jv, cache=JaxArtifactCache(str(tmp_path / "jax")), **kw))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("norm,eps", [("l2", 0.1), ("linf", 0.05)])
def test_uap_epoch_matches_jax(setup, tmp_path, optimizer, norm, eps):
    _, _, pv, images, labels = setup
    atk, jatk = _both_uappgd(setup, tmp_path, batch_size=4, norm=norm, eps=eps,
                             optimizer=optimizer)
    plans = _jax_plans(N, 4, 2)  # 3 batches of 4 an epoch, the last padded by 2
    assert (plans[0] == -1).sum() == 2
    je = jnp.zeros((1, SIZE, SIZE, 3))
    jopt = jatk.make_optimizer().init(je)
    jepoch = juap.make_uap_epoch_fn(jatk.victim.apply_fn, jatk)
    e = torch.zeros((1, SIZE, SIZE, 3), requires_grad=True)
    opt = atk.make_optimizer([e])
    epoch = uap_pgd.make_uap_epoch_fn(pv, atk)
    for plan in plans:
        je, jopt, jloss, jfool = jepoch(je, jopt, jnp.asarray(images),
                                        jnp.asarray(labels, jnp.int32), jnp.asarray(plan))
        loss, fool = epoch(e, opt, t(images), torch.tensor(labels), torch.tensor(plan))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(fool) == float(jfool)
    _assert_uap_close(e.detach(), je, norm)
    if norm == "l2":
        assert float(e.detach().norm()) <= eps + 1e-6


def test_presliced_epoch_matches_jax_and_the_gather_epoch(setup, tmp_path):
    _, _, pv, images, labels = setup
    atk, jatk = _both_uappgd(setup, tmp_path, batch_size=4, norm="l2", eps=0.1)
    plan = _jax_plans(N, 4, 1)[0]
    je = jnp.zeros((1, SIZE, SIZE, 3))
    sliced = jcore.preslice_epoch(jnp.asarray(images), jnp.asarray(labels, jnp.int32),
                                  jnp.asarray(plan))
    je, _, jloss, _ = juap.make_uap_epoch_fn_presliced(jatk.victim.apply_fn, jatk)(
        je, jatk.make_optimizer().init(je), *sliced)
    outs = []
    for presliced in (True, False):
        e = torch.zeros((1, SIZE, SIZE, 3), requires_grad=True)
        opt = atk.make_optimizer([e])
        if presliced:
            args = core.preslice_epoch(t(images), torch.tensor(labels), torch.tensor(plan))
            loss, _ = uap_pgd.make_uap_epoch_fn_presliced(pv, atk)(e, opt, *args)
        else:
            loss, _ = uap_pgd.make_uap_epoch_fn(pv, atk)(e, opt, t(images), torch.tensor(labels),
                                                         torch.tensor(plan))
        outs.append((e.detach(), float(loss)))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    assert _max_err(outs[0][0], je) <= 1e-5
    np.testing.assert_allclose(outs[0][1], float(jloss), rtol=1e-5)


@pytest.mark.parametrize("norm,eps", [("l2", 0.1), ("linf", 0.05)])
def test_learn_attack_in_one_batch_matches_jax(setup, tmp_path, norm, eps):
    # batch_size >= n: each epoch is one batch of every row, whatever the
    # order each package's generator draws, so the whole run compares.
    _, _, _, images, labels = setup
    atk, jatk = _both_uappgd(setup, tmp_path, batch_size=16, norm=norm, eps=eps)
    atk.steps = jatk.steps = 3
    val = (images[:6], labels[:6])
    atk.learn_attack((images, labels), val)
    jatk.learn_attack((images, labels), val)
    _assert_uap_close(atk.attack_vec, jatk.attack_vec, norm)
    np.testing.assert_allclose(atk.history["loss"], jatk.history["loss"], rtol=1e-5)
    assert atk.history["fooling_rate"] == jatk.history["fooling_rate"]
    assert atk.is_trained and atk.cache.exists("UAPPGD", model="tiny")


def test_additive_fooling_rate_matches_jax(setup):
    jv, variables, pv, images, _ = setup
    # Twice one image's DeepFool step: Gaussian noise fools this victim on
    # no image, this changes some predictions and not all.
    e = 2 * deepfool_batch(pv, t(images[:1]))[0].numpy()
    got = uap_pgd.additive_fooling_rate(pv, t(e), t(images), batch_size=4)
    want = juap.additive_fooling_rate(jv.apply_fn, variables, jnp.asarray(e),
                                      jnp.asarray(images), batch_size=4)
    assert got == want and 0 < got < 1


# -- DeepFool ------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_deepfool_batch_matches_jax(setup, masked):
    jv, variables, pv, images, _ = setup
    active = np.array([True, False, True, True, False, True, True, True])
    kw = dict(active_init=active) if masked else {}
    jr, jiters = jdf.cached_deepfool(jv.apply_fn, 10, 0.02, 10)(
        variables, jnp.asarray(images[:8]), **{k: jnp.asarray(v) for k, v in kw.items()})
    r, iters = deepfool_batch(pv, t(images[:8]), 10, 0.02, 10,
                              **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert iters.dtype == torch.int32 and int(iters.max()) > 1
    assert _max_err(r, jr) <= 1e-5
    if masked:
        assert not iters[~torch.tensor(active)].any() and not r[~torch.tensor(active)].any()
    else:
        adv = DeepFool(pv, steps=10)(t(images[:8]))
        assert _max_err(adv, jnp.clip(jnp.asarray(images[:8]) + jr, 0, 1)) <= 1e-5


@pytest.mark.parametrize("init_shape", [(SIZE, SIZE, 3), (1, SIZE, SIZE, 3)])
def test_deepfool_cosinus_matches_jax(setup, init_shape):
    jv, variables, pv, images, _ = setup
    init = _noise(7, init_shape, 0.05)
    want = jfast._cosinus_cache(jv.apply_fn, 0.02, 10)(variables, jnp.asarray(images[:6]),
                                                       jnp.asarray(init))
    got = fast_uap.deepfool_cosinus_batch(pv, t(images[:6]), t(init), max_iter=10)
    assert _max_err(got, want) <= 1e-5
    assert _max_err(got, t(images[:6])) > 0.01  # it moved
    via_class = DeepFoolCosinus(pv, steps=10)(images[:6], attack_init=init)
    assert torch.equal(via_class, got)


def test_batched_jacobian_is_each_image_jacobian():
    # Port only, on ResNet-18 at 32x32 in inference mode with random
    # BatchNorm statistics: the k backward passes of one batched forward
    # against torch.autograd.functional.jacobian of image i's selected
    # logits with respect to the whole batch. Its block for image i is that
    # image's Jacobian (within 1e-6 of the largest entry) and its blocks for
    # the other images are zero: no row depends on another. (Against a
    # forward of image i alone, a max-pool window whose top two inputs round
    # the other way at batch 1 moves one entry by 2e-3.)
    victim = create_model("resnet18", input_size=32, num_classes=10, device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in victim.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
    x = torch.rand((3, 32, 32, 3), generator=g)
    top_idx = torch.topk(victim(x), 4, dim=1).indices
    leaf, logits = deepfool.forward_with_graph(victim, x)
    jac = deepfool.selected_jacobian(leaf, logits, top_idx)
    assert jac.shape == (3, 4, 32, 32, 3)
    for i in range(3):
        want = torch.autograd.functional.jacobian(lambda xs: victim(xs)[i][top_idx[i]], x)
        scale = float(want[:, i].abs().max())
        assert scale > 0 and float((jac[i] - want[:, i]).abs().max()) <= 1e-6 * scale
        assert not want[:, np.arange(3) != i].any()


# -- Fast-UAP and the universal perturbation ---------------------------------

@pytest.mark.parametrize("chunk", [1, 4])  # 4: a ragged tail of 2, padded
def test_fast_uap_matches_jax(setup, tmp_path, chunk):
    jv, _, pv, images, labels = setup
    kw = dict(steps=2, eps=0.3, norm="linf", steps_deepfool=10, chunk=chunk)
    data, val = (images, labels), (images[:6], labels[:6])
    atk = FastUAP(pv, cache=ArtifactCache(str(tmp_path / "port")), **kw)
    jatk = JaxFastUAP(jv, cache=JaxArtifactCache(str(tmp_path / "jax")), **kw)
    atk.learn_attack(data, val)
    jatk.learn_attack(data, val)
    assert atk.attack_vec.shape == (1, SIZE, SIZE, 3)
    assert _max_err(atk.attack_vec, jatk.attack_vec) <= 1e-5
    assert float(atk.attack_vec.abs().max()) > 0.01
    assert atk.history["fooling_rate"] == jatk.history["fooling_rate"]


@pytest.mark.parametrize("chunk", [1, 4])
def test_universal_perturbation_matches_jax(setup, tmp_path, chunk):
    jv, _, pv, images, labels = setup
    # xi 6/255 keeps the val fooling rate under 1 - delta, so both passes run.
    kw = dict(max_iter_uni=2, xi=6 / 255, p="linf", max_iter_df=10, seed=3, chunk=chunk)
    data, val = (images, labels), (images[:6], labels[:6])
    v, history = universal_perturbation(data, val, pv, save_path=str(tmp_path / "v.npy"), **kw)
    jv_, jhistory = jax_universal_perturbation(data, val, jv, **kw)
    assert v.shape == (SIZE, SIZE, 3)
    assert _max_err(v, jv_) <= 1e-5
    assert float(v.abs().max()) > 0.01
    assert history == jhistory and len(history) == 2
    np.testing.assert_array_equal(np.load(tmp_path / "v.npy"), v.numpy())


# -- artifacts and the harness -----------------------------------------------

@pytest.mark.parametrize("kind", ["UAPPGD", "FastUAP"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_artifact_of_one_package_serves_in_the_other(setup, tmp_path, kind, writer):
    jv, _, pv, images, labels = setup
    root = str(tmp_path)
    port_cls, jax_cls = (UAPPGD, JaxUAPPGD) if kind == "UAPPGD" else (FastUAP, JaxFastUAP)
    kw = dict(steps=1, norm="l2", eps=0.1, batch_size=16) if kind == "UAPPGD" else dict(
        steps=1, steps_deepfool=10)
    data, val = (images[:4], labels[:4]), (images[4:7], labels[4:7])
    if writer == "port":
        port_cls(pv, data_train=data, data_val=val, cache=ArtifactCache(root), **kw)
        reader = jax_cls(jv, cache=JaxArtifactCache(root), **kw)
        other = port_cls(pv, cache=ArtifactCache(root), **kw)
    else:
        jax_cls(jv, data_train=data, data_val=val, cache=JaxArtifactCache(root), **kw)
        reader = port_cls(pv, cache=ArtifactCache(root), **kw)
        other = jax_cls(jv, cache=JaxArtifactCache(root), **kw)
    assert reader.is_trained and other.is_trained
    x = images[6:]
    got, want = reader(x, labels[6:]), other(x, labels[6:])
    assert _max_err(got, want) == 0.0 and _max_err(got, x) > 0
    payload = ArtifactCache(root).load(kind, model="tiny")
    assert payload["e"].shape == (1, SIZE, SIZE, 3) and payload["fooling_rate"].shape == (1,)


def test_harness_learns_an_untrained_uap_lazily_like_jax(setup, tmp_path):
    # One batch of 10 with 3 wrong labels: the 7 kept rows are padded back
    # to 10 by cycling, and each untrained attack learns on the 7 real kept
    # rows first (UAP-PGD in one batch of them, so both packages' plans hold
    # the same rows).
    jv, _, pv, images, labels = setup
    wrong = labels.copy()
    wrong[[1, 4, 8]] = (wrong[[1, 4, 8]] + 1) % 10
    loader = [(images, wrong)]
    uap_kw = dict(steps=2, batch_size=16, norm="l2", eps=2.0, step_size=0.05, model_name="h")
    fast_kw = dict(steps=1, steps_deepfool=10, model_name="h")
    got_atks = {"uappgd": [UAPPGD(pv, cache=ArtifactCache(str(tmp_path / "p")), **uap_kw)],
                "fastuap": [FastUAP(pv, cache=ArtifactCache(str(tmp_path / "p")), **fast_kw)]}
    want_atks = {"uappgd": [JaxUAPPGD(jv, cache=JaxArtifactCache(str(tmp_path / "j")), **uap_kw)],
                 "fastuap": [JaxFastUAP(jv, cache=JaxArtifactCache(str(tmp_path / "j")),
                                        **fast_kw)]}
    assert not any(a[0].is_trained for a in got_atks.values())
    got = ev.get_performance(got_atks, pv, loader)
    want = jev.get_performance(want_atks, jv, loader)
    assert got["group_key"] == want["group_key"]
    for name in ("uappgd", "fastuap"):
        assert got_atks[name][0].is_trained
        assert _max_err(got_atks[name][0].attack_vec, want_atks[name][0].attack_vec) <= 1e-5
    kept = np.delete(np.arange(N), [1, 4, 8])
    direct = UAPPGD(pv, cache=ArtifactCache(str(tmp_path / "d")), **uap_kw)
    direct.learn_attack((images[kept], labels[kept]))
    assert torch.equal(direct.attack_vec, got_atks["uappgd"][0].attack_vec)
    for key in want["fooling_rate"]:
        assert got["fooling_rate"][key] == want["fooling_rate"][key]
        np.testing.assert_allclose(got["rmse"][key], want["rmse"][key], rtol=1e-5)
        np.testing.assert_allclose(got["mse"][key], want["mse"][key], rtol=1e-5)
    assert max(f[0] for f in got["fooling_rate"].values()) > 0
