"""The port's ADIL learns dictionaries: against the JAX class in ``alter`` mode
from one warm-start D (atol 1e-4), kill-and-resume equal to the straight
run on every path, artifact memoization, the lazy learn in ``forward``, and
a JAX train-state checkpoint left alone."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
from dl_attack_on_imagenet_tpu_torch.ops import kernels
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t, victim_pair

K, SIZE = 4, 32


@pytest.fixture(scope="module")
def victims():
    jv, variables, pv = victim_pair("tiny", seed=3)
    return dataclasses.replace(jv, variables=variables), pv


@pytest.fixture(scope="module")
def dataset():
    images = np.random.RandomState(3).uniform(0.0, 1.0, (10, SIZE, SIZE, 3)).astype(np.float32)
    return ArrayDataset(images, np.zeros((10,), np.int64))


class Boom(Exception):
    pass


def _bomb_val(attack, at):
    calls = {"n": 0}

    def bomb(d, data_val):
        calls["n"] += 1
        if calls["n"] == at:
            raise Boom()
        return 0.0

    attack._val_fooling = bomb


def test_alter_matches_the_jax_class_from_one_warm_start(victims, dataset, tmp_path):
    # batch_size >= n: each epoch is one batch of every image, so the two
    # packages' different shuffles cannot change the trajectory.
    jv, pv = victims
    d0 = np.random.RandomState(4).uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(steps=3, n_atoms=K, batch_size=12, method="alter", warm_start=True,
              loss="logits", eps=3.0, model_name="warm", checkpoint_every=None)
    jcache = JaxArtifactCache(str(tmp_path / "jax"))
    jcache.save({"d": d0}, "ImageNet", model="warm")
    want = JaxADIL(jv, cache=jcache, **kw)
    want.learn_dictionary((dataset.images[:6], dataset.labels[:6]))
    cache = ArtifactCache(str(tmp_path / "port"))
    cache.save({"d": d0}, "ImageNet", model="warm")
    got = ADIL(pv, cache=cache, **kw)
    got.learn_dictionary((dataset.images[:6], dataset.labels[:6]))
    assert got.dictionary.shape == (K, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.dictionary.numpy(), np.asarray(want.dictionary),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], atol=1e-4, rtol=0)
    assert got.history["fooling_rate"] == pytest.approx(want.history["fooling_rate"])
    saved = cache.load("ImageNet", model="warm")
    np.testing.assert_allclose(saved["v"], np.asarray(jcache.load("ImageNet", model="warm")["v"]),
                               atol=1e-4, rtol=0)
    assert sorted(saved) == sorted(jcache.load("ImageNet", model="warm"))


def test_val_fooling_matches_jax_on_a_ragged_val_set(victims, dataset, tmp_path):
    jv, pv = victims
    d = np.random.RandomState(5).uniform(-1.0, 1.0, (K, SIZE * SIZE * 3)).astype(np.float32)
    val = (dataset.images[:6], dataset.labels[:6])  # batch 4: one full, one ragged
    kw = dict(n_atoms=K, batch_size=4, loss="logits", eps=3.0)  # large enough to fool some
    want = JaxADIL(jv, cache=JaxArtifactCache(str(tmp_path)), **kw)._val_fooling(jnp.asarray(d), val)
    got = ADIL(pv, cache=ArtifactCache(str(tmp_path)), **kw)._val_fooling(t(d), val)
    assert 0 < got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("path", [
    dict(method="gd", stream=False),
    dict(method="gd", stream=True),
    dict(method="alter"),
])
def test_kill_and_resume_equals_the_straight_run(victims, dataset, tmp_path, path):
    _, pv = victims

    def run(cache):
        return ADIL(pv, steps=4, n_atoms=K, batch_size=4, cache=cache, model_name="ckpt",
                    checkpoint_every=1, seed=0, **path)

    straight = run(ArtifactCache(str(tmp_path / "a")))
    straight.learn_dictionary(dataset, None)

    cache = ArtifactCache(str(tmp_path / "b"))
    crashy = run(cache)
    _bomb_val(crashy, at=3)
    with pytest.raises(Boom):
        crashy.learn_dictionary(dataset, ArrayDataset(dataset.images[:4], dataset.labels[:4]))
    # Epochs 0 and 1 were checkpointed before the crash in epoch 2.
    assert cache.exists("ImageNet", model="ckpt", kind="train_state_torch")
    assert not cache.exists("ImageNet", model="ckpt")

    resumed = run(cache)
    resumed.learn_dictionary(dataset, None)
    assert len(resumed.history["loss"]) == 4
    assert resumed.history["loss"] == pytest.approx(straight.history["loss"], abs=1e-7)
    assert not cache.exists("ImageNet", model="ckpt", kind="train_state_torch")
    assert torch.equal(resumed.dictionary, straight.dictionary)


def test_memoized_artifact_is_loaded_not_trained(victims, dataset, tmp_path, monkeypatch):
    _, pv = victims
    cache = ArtifactCache(str(tmp_path))
    kw = dict(steps=2, n_atoms=K, batch_size=4, cache=cache, loss="logits")
    first = ADIL(pv, data_train=dataset, **kw)
    assert first.is_trained and len(first.history["loss"]) == 2
    saved = cache.load("ImageNet", model="tiny")
    assert saved["d"].shape == (K, SIZE, SIZE, 3) and saved["v"].shape == (10, K)
    assert float(np.abs(saved["d"]).max()) <= 1.0
    assert float(np.abs(saved["v"]).sum(1).max()) <= 8 / 255 + 1e-6

    def refuse(*_args, **_kwargs):
        raise AssertionError("the second construction trained")

    monkeypatch.setattr(ADIL, "learn_dictionary", refuse)
    second = ADIL(pv, data_train=dataset, **kw)
    assert second.is_trained
    assert torch.equal(second._load_dictionary(), first.dictionary)


def test_forward_learns_lazily_on_its_batch(victims, dataset, tmp_path):
    _, pv = victims
    attack = ADIL(pv, steps=1, n_atoms=K, batch_size=4, cache=ArtifactCache(str(tmp_path)),
                  loss="logits", steps_inference=2)
    assert not attack.is_trained
    x = t(dataset.images[:4])
    adv = attack(x)
    assert attack.is_trained and attack.history["loss"]
    assert adv.shape == x.shape and bool(torch.isfinite(adv).all())


def test_port_ignores_a_jax_train_state_checkpoint(victims, dataset, tmp_path):
    import jax

    jv, pv = victims
    jax_attack = JaxADIL(jv, steps=3, n_atoms=K, batch_size=4, model_name="shared",
                         cache=JaxArtifactCache(str(tmp_path)), checkpoint_every=1)
    state = jcore.init_state(jax.random.PRNGKey(0), (SIZE, SIZE, 3), 10, jax_attack.cfg)
    jax_attack._save_train_state(state.replace(epoch=jnp.asarray(99)),
                                 jax.random.PRNGKey(1), [1.0], [0.0])
    cache = ArtifactCache(str(tmp_path))
    assert cache.exists("ImageNet", model="shared", kind="train_state")
    attack = ADIL(pv, steps=3, n_atoms=K, batch_size=4, model_name="shared", cache=cache,
                  checkpoint_every=1, resume=True, data_train=dataset)
    assert len(attack.history["loss"]) == 3  # a fresh run, not epoch 99's
    assert cache.exists("ImageNet", model="shared", kind="train_state")  # left alone
    assert not cache.exists("ImageNet", model="shared", kind="train_state_torch")


def test_gd_step_launches_the_optimizer_on_both_halves(victims, dataset, tmp_path, monkeypatch):
    _, pv = victims
    calls = []
    real = core.fused_adamw_project

    def counting(p, g, mu, nu, step, lr, clip_val=1.0):
        calls.append((tuple(p.shape), step, lr, clip_val))
        return real(p, g, mu, nu, step, lr, clip_val)

    monkeypatch.setattr(core, "fused_adamw_project", counting)
    ADIL(pv, steps=1, n_atoms=K, batch_size=4, cache=ArtifactCache(str(tmp_path / "gd")),
         data_train=dataset)  # 3 batches of 10 images
    d_shape, v_shape = (K, SIZE * SIZE * 3), (10, K)
    inf = float("inf")
    assert calls == [c for s in (1, 2, 3) for c in ((d_shape, s, 0.01, 1.0), (v_shape, s, 0.01, inf))]
    calls.clear()
    ADIL(pv, steps=1, n_atoms=K, batch_size=10, method="alter", norm="l2", eps=0.5,
         cache=ArtifactCache(str(tmp_path / "alter")), data_train=dataset)
    assert calls == [(v_shape, 1, 0.01, inf), (d_shape, 1, 0.02, inf)]
    assert kernels.fused_adamw_project.launches == 0  # the CPU takes the plain twin
