"""Port ADiL serving solvers against the JAX core on the tiny victim
(N=4, K=8): the supervised solvers over 5 steps within atol 1e-5, so that
the tol early stop cannot fire at another step; unsupervised sampling with
shared codes within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core

from _torch_port import t, victim_pair

N, K, SIZE = 4, 8, 32


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny")
    rs = np.random.RandomState(0)
    d = rs.uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    x = rs.uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    return jv, variables, pv, d, x


def _cfgs(**kw):
    kw = dict(n_atoms=K, steps_inference=5, steps_code=5, **kw)
    return jcore.AdilConfig(**kw), core.AdilConfig(**kw)


@pytest.mark.parametrize("loss", ["logits", "ce"])
def test_supervised_ddrague_matches_jax(setup, loss):
    jv, variables, pv, d, x = setup
    jcfg, cfg = _cfgs(loss=loss)
    want = jcore.supervised_ddrague(jv.apply_fn, variables, jnp.asarray(d), jnp.asarray(x), jcfg)
    got = core.supervised_ddrague(pv, t(d), t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_supervised_adamw_codes_matches_jax(setup, norm):
    jv, variables, pv, d, x = setup
    jcfg, cfg = _cfgs(loss="logits", norm=norm, eps=0.05)
    want = jcore.supervised_adamw_codes(jv.apply_fn, variables, jnp.asarray(d), jnp.asarray(x), jcfg)
    got = core.supervised_adamw_codes(pv, t(d), t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want_fool = jcore.supervised_adamw_codes(jv.apply_fn, variables, jnp.asarray(d),
                                             jnp.asarray(x), jcfg, return_fooling=True)
    assert int(core.supervised_adamw_codes(pv, t(d), t(x), cfg, return_fooling=True)) == int(want_fool)


def test_unsupervised_sample_matches_jax_with_shared_codes(setup):
    jv, variables, pv, d, x = setup
    jcfg, cfg = _cfgs(trials=6, eps=0.1)
    v_trials = np.random.RandomState(3).uniform(0.0, 0.5, (6, N, K)).astype(np.float32)
    want = jcore.unsupervised_sample(jv.apply_fn, variables, jnp.asarray(d), jnp.asarray(x),
                                     jax.random.PRNGKey(0), jcfg, v_trials=jnp.asarray(v_trials))
    got = core.unsupervised_sample(pv, t(d), t(x), None, cfg, v_trials=t(v_trials))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_unsupervised_selection_matches_jax_when_some_trials_fool(setup):
    # The tiny victim is too flat for any trial to fool it; a linear victim
    # with the same weights on both sides is fooled by some trials only, so
    # the fooling and non-fooling selections both run.
    *_, d, x = setup
    w = np.random.RandomState(5).normal(0.0, 1.0, (SIZE * SIZE * 3, 10)).astype(np.float32)
    jcfg, cfg = _cfgs(trials=6, eps=0.02)
    v_trials = np.random.RandomState(3).uniform(0.0, 0.1, (6, N, K)).astype(np.float32)
    want = jcore.unsupervised_sample(
        lambda ww, xx: xx.reshape(xx.shape[0], -1) @ ww, jnp.asarray(w), jnp.asarray(d),
        jnp.asarray(x), jax.random.PRNGKey(0), jcfg, v_trials=jnp.asarray(v_trials))
    linear = lambda xx: xx.reshape(xx.shape[0], -1) @ t(w)
    got = core.unsupervised_sample(linear, t(d), t(x), None, cfg, v_trials=t(v_trials))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    fooled = linear(got).argmax(-1) != linear(t(x)).argmax(-1)
    assert 0 < int(fooled.sum()) < N


def test_predict_labels_matches_jax(setup):
    jv, variables, pv, d, x = setup
    want = jcore.predict_labels(jv.apply_fn, variables, jnp.asarray(x), batch_size=3)
    np.testing.assert_array_equal(core.predict_labels(pv, t(x), batch_size=3).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_sample_sphere_lands_on_the_budget_sphere(norm):
    cfg = core.AdilConfig(n_atoms=K, norm=norm, eps=0.1)
    v = core.sample_sphere(torch.Generator().manual_seed(0), 5, cfg)
    assert v.shape == (5, K)
    norms = v.abs().sum(1) if norm == "linf" else torch.linalg.norm(v, dim=1)
    np.testing.assert_allclose(norms.numpy(), 0.1, atol=1e-6)


def test_init_dictionary_ranges():
    g = torch.Generator().manual_seed(0)
    d = core.init_dictionary(g, (4, 4, 3), core.AdilConfig(n_atoms=6))
    assert d.shape == (6, 4, 4, 3) and float(d.abs().max()) <= 1.0
    d2 = core.init_dictionary(g, (4, 4, 3), core.AdilConfig(n_atoms=6, norm="l2"))
    assert float(torch.linalg.norm(d2.reshape(6, -1), dim=1).max()) <= 1.0 + 1e-6


def test_perturb_dtype_other_than_float32_is_not_ported():
    with pytest.raises(NotImplementedError):
        core.AdilConfig(perturb_dtype="bfloat16")


def test_every_adversary_goes_through_fused_perturb(setup, monkeypatch):
    _, _, pv, d, x = setup
    calls = []
    real = core.fused_perturb

    def counting(v, dd, xx, eps):
        calls.append(eps)
        return real(v, dd, xx, eps)

    monkeypatch.setattr(core, "fused_perturb", counting)
    cfg = core.AdilConfig(n_atoms=K, steps_inference=2, steps_code=2, trials=3)
    core.unsupervised_sample(pv, t(d), t(x), torch.Generator().manual_seed(0), cfg)
    assert calls == [cfg.eps] * 3  # one launch per trial, clamped at eps
    calls.clear()
    core.supervised_ddrague(pv, t(d), t(x), cfg)
    core.supervised_adamw_codes(pv, t(d), t(x), cfg)
    assert calls == [float("inf")] * 2  # one unclamped read-off per solver
