"""The port's ``ADIL(blocked=...)`` and ``ADIL(pipeline_epochs=...)``
against the JAX package's and against the port's standard serial loop: the
blocked ``gd`` run, its presentation artifact and its checkpoint kind,
supervised serving through the blocked twin, and the pipelined epochs with
their convergence stop and checkpoint resume. The victim is a ResNet-18
with an S2D stem, its weights drawn in numpy for the JAX module's shapes
(``test_torch_port_zoo.zoo_pair``); the stems themselves are held against
the JAX package in ``test_torch_port_s2d``, and the data-parallel blocked
learning against its replay in ``test_torch_port_parallel``.

Tolerances: a blocked ``gd`` run within 1e-4 of the JAX package's blocked
run and of the port's standard run, in D and in the losses
(``test_torch_port_adil_train``'s tolerance); served adversaries within
1e-5 of the JAX package's and of the standard layout's
(``test_torch_port_checkpoint``'s); a killed and resumed run, and the
pipelined loop, exactly equal to the straight serial one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.models.convert import train_state_from_jax
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t, victim_pair
from test_torch_port_zoo import zoo_pair

ATOL = 1e-4
K = 4


# -- ADIL in the blocked layout ---------------------------------------------

N, SIZE = 4, 32


@pytest.fixture(scope="module")
def s2d_pair():
    jv, pv = zoo_pair("resnet18", SIZE, seed=2, stem_s2d=True)
    x = np.random.RandomState(3).uniform(0.0, 1.0, (N, SIZE, SIZE, 3)).astype(np.float32)
    return jv, pv, x


def _jax_start(jax_attack):
    """The JAX class's initial gd state, as numpy leaves."""
    state = jcore.init_state(jax.random.PRNGKey(jax_attack.seed), (SIZE, SIZE, 3), N,
                             jax_attack.cfg, mode="gd")
    return jax.tree_util.tree_map(np.asarray, state)


def test_blocked_gd_matches_jax_and_the_standard_layout(s2d_pair, tmp_path):
    # batch_size > n: one batch an epoch, so the packages' different
    # shuffles cannot change the trajectory; both start from the JAX state.
    jv, pv, x = s2d_pair
    kw = dict(steps=3, n_atoms=K, batch_size=8, loss="logits", eps=3.0, pipeline_epochs=False)
    want = JaxADIL(jv, cache=JaxArtifactCache(str(tmp_path / "jax")), blocked=True, **kw)
    want.learn_dictionary((x, np.zeros(N)))
    assert want.trained_blocked
    start = _jax_start(want)
    runs = {}
    for blocked in (True, False):
        cache = ArtifactCache(str(tmp_path / f"port{blocked}"))
        got = ADIL(pv, cache=cache, blocked=blocked, **kw)
        got._init = lambda *_args: train_state_from_jax(start, device="cpu")
        got.learn_dictionary((x, np.zeros(N)))
        assert got.trained_blocked == blocked
        saved = cache.load("ImageNet", model="resnet18")
        assert saved["d"].shape == (K, SIZE, SIZE, 3) and saved["v"].shape == (N, K)
        np.testing.assert_array_equal(saved["d"], got.dictionary.numpy())
        runs[blocked] = got
    for got in runs.values():
        np.testing.assert_allclose(got.dictionary.numpy(), np.asarray(want.dictionary),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.history["loss"], want.history["loss"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(runs[True].dictionary.numpy(), runs[False].dictionary.numpy(),
                               atol=ATOL, rtol=0)


def test_blocked_run_checkpoints_under_its_own_kind_and_resumes(s2d_pair, tmp_path):
    _, pv, x = s2d_pair
    kw = dict(steps=3, n_atoms=K, batch_size=2, loss="logits", checkpoint_every=1,
              model_name="s2d")
    whole = ADIL(pv, cache=ArtifactCache(str(tmp_path / "whole")), **kw)
    whole.learn_dictionary((x, np.zeros(N)))

    class Killed(Exception):
        pass

    cache = ArtifactCache(str(tmp_path / "killed"))
    probe = ADIL(pv, cache=cache, **kw)
    saves = []

    def save_then_kill(state, generator, history):
        saves.append(state.epoch)
        if len(saves) == 2:
            raise Killed
        ADIL._save_train_state(probe, state, generator, history)

    probe._save_train_state = save_then_kill
    with pytest.raises(Killed):
        probe.learn_dictionary((x, np.zeros(N)))
    assert cache.exists("ImageNet", model="s2d", kind="train_state_s2d_torch")
    assert not cache.exists("ImageNet", model="s2d", kind="train_state_torch")
    resumed = ADIL(pv, cache=cache, **kw)
    resumed.learn_dictionary((x, np.zeros(N)))
    assert resumed.trained_blocked and resumed.history["loss"] == whole.history["loss"]
    assert torch.equal(resumed.dictionary, whole.dictionary)
    assert not cache.exists("ImageNet", model="s2d", kind="train_state_s2d_torch")
    # The streamed and alter paths train unblocked.
    for path in (dict(stream=True), dict(method="alter")):
        other = ADIL(pv, cache=ArtifactCache(str(tmp_path / str(path))),
                     **{**kw, "checkpoint_every": None, "steps": 1}, **path)
        other.learn_dictionary((x, np.zeros(N)))
        assert not other.trained_blocked
        assert other.dictionary.shape == (K, SIZE, SIZE, 3)


def _serve(attack, solver: str, x):
    """``attack``'s supervised ``solver`` on x, and whether it went through
    the blocked twin."""
    calls = []
    real = attack._blocked_supervised
    attack._blocked_supervised = lambda *a: calls.append(real(*a)) or calls[-1]
    args = (x,) if solver == "forward_supervised_adamw" else (x, np.zeros(len(x)))
    return getattr(attack, solver)(*map(t, args)).numpy(), calls[-1] is not None


def test_ddrague_through_the_twin_matches_jax(s2d_pair, tmp_path):
    # Both packages serve an S2D victim through its twin. On this random
    # ResNet-18 the packages' standard layouts are already up to 7e-4 apart
    # after 5 AdamW steps (ROADMAP.md queue 3); the blocked layout must add
    # nothing to that, and equal the port's standard layout within 1e-5.
    jv, pv, x = s2d_pair
    d = np.random.RandomState(4).uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    JaxArtifactCache(str(tmp_path)).save({"d": d}, "ImageNet", model="resnet18")
    kw = dict(n_atoms=K, loss="logits", steps_inference=5, eps=0.1)
    out = {}
    for blocked in (True, False):
        jattack = JaxADIL(jv, cache=JaxArtifactCache(str(tmp_path)), blocked=blocked, **kw)
        out["jax", blocked] = np.asarray(jattack(jnp.asarray(x), jnp.zeros(N)))
        attack = ADIL(pv, cache=ArtifactCache(str(tmp_path)), blocked=blocked, **kw)
        out["port", blocked], through_twin = _serve(attack, "forward", x)
        assert through_twin == blocked and out["port", blocked].shape == x.shape
    np.testing.assert_allclose(out["port", True], out["port", False], atol=1e-5, rtol=0)
    gap = float(np.abs(out["port", False] - out["jax", False]).max())
    assert float(np.abs(out["port", True] - out["jax", True]).max()) <= gap + 1e-5
    assert attack._blocked_dict(attack.dictionary) is attack._blocked_dict(attack.dictionary)


def test_adamw_codes_through_the_twin_match_the_standard_layout(s2d_pair, tmp_path):
    # Cut to 5 code steps: over the default 100 the l1-projected AdamW codes
    # amplify the layouts' rounding differences past 1e-5.
    _, pv, x = s2d_pair
    d = np.random.RandomState(4).uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    ArtifactCache(str(tmp_path)).save({"d": d}, "ImageNet", model="resnet18")
    out = {}
    for blocked in (True, False):
        attack = ADIL(pv, cache=ArtifactCache(str(tmp_path)), blocked=blocked, n_atoms=K,
                      loss="logits", eps=0.1)
        attack.cfg = dataclasses.replace(attack.cfg, steps_code=5)
        out[blocked], through_twin = _serve(attack, "forward_supervised_adamw", x)
        assert through_twin == blocked
    np.testing.assert_allclose(out[True], out[False], atol=1e-5, rtol=0)


# -- pipeline_epochs ----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    _, _, pv = victim_pair("tiny", key=7)
    rs = np.random.RandomState(3)
    images = rs.uniform(0.0, 1.0, (16, 32, 32, 3)).astype(np.float32)
    return pv, (images, rs.randint(0, 10, 16))


def _train(pv, data, path, pipeline, tol=None, **kw):
    attack = ADIL(pv, n_atoms=K, batch_size=8, cache=ArtifactCache(str(path)), seed=0,
                  val_every=None, pipeline_epochs=pipeline, **{"steps": 6, **kw})
    if tol is not None:
        attack.cfg = dataclasses.replace(attack.cfg, tol=tol)
    attack.learn_dictionary(data, None)
    return attack


def test_pipelined_trajectory_equals_serial(tiny, tmp_path):
    pv, data = tiny
    a = _train(pv, data, tmp_path / "p", True)
    b = _train(pv, data, tmp_path / "s", False)
    assert a.history["loss"] == b.history["loss"] and len(a.history["loss"]) == 6
    assert a.history["fooling_rate"] == b.history["fooling_rate"]
    assert torch.equal(a.dictionary, b.dictionary)
    assert np.array_equal(ArtifactCache(str(tmp_path / "p")).load("ImageNet", model="tiny")["v"],
                          ArtifactCache(str(tmp_path / "s")).load("ImageNet", model="tiny")["v"])
    assert a.timing["steps"] == b.timing["steps"] == 5  # six epochs, the first left out


def test_convergence_stop_returns_the_serial_state(tiny, tmp_path):
    # A large tol stops the loop early; the pipelined loop has enqueued the
    # next epoch by then and must give epoch t's state.
    pv, data = tiny
    a = _train(pv, data, tmp_path / "p", True, tol=1e-2, steps=30)
    b = _train(pv, data, tmp_path / "s", False, tol=1e-2, steps=30)
    assert 3 <= len(a.history["loss"]) == len(b.history["loss"]) < 30
    assert a.history["loss"] == b.history["loss"]
    assert torch.equal(a.dictionary, b.dictionary)


def test_pipelined_checkpoint_resume_matches_uninterrupted(tiny, tmp_path):
    pv, data = tiny

    class Killed(Exception):
        pass

    whole = _train(pv, data, tmp_path / "whole", True, steps=5, checkpoint_every=1)
    cache_dir = tmp_path / "killed"
    probe = ADIL(pv, n_atoms=K, batch_size=8, cache=ArtifactCache(str(cache_dir)), seed=0,
                 val_every=None, pipeline_epochs=True, steps=5, checkpoint_every=1)
    saves = []

    def save_then_kill(state, generator, history):
        saves.append(state.epoch)
        if len(saves) == 3:
            raise Killed
        ADIL._save_train_state(probe, state, generator, history)

    probe._save_train_state = save_then_kill
    with pytest.raises(Killed):
        probe.learn_dictionary(data, None)
    assert saves == [1, 2, 3]  # each checkpoint holds its own epoch's state
    resumed = _train(pv, data, cache_dir, True, steps=5, checkpoint_every=1)
    serial = _train(pv, data, tmp_path / "serial", False, steps=5)
    for run in (resumed, serial):
        assert run.history["loss"] == whole.history["loss"]
        assert torch.equal(run.dictionary, whole.dictionary)


def test_auto_resolves_against_the_device_memory(tiny, tmp_path, monkeypatch):
    from dl_attack_on_imagenet_tpu_torch.attacks import adil as adil_mod

    pv, data = tiny
    attack = ADIL(pv, n_atoms=K, cache=ArtifactCache(str(tmp_path)))
    images = t(data[0])
    state = attack._init((32, 32, 3), 16, attack._generator(), "gd")
    assert attack._resolve_pipeline(images, state)  # the CPU's 64 GiB
    need = 3 * images.numel() * 4 + 3 * sum(
        v.numel() * 4 for v in vars(state).values() if isinstance(v, torch.Tensor))
    monkeypatch.setattr(adil_mod, "_device_memory_budget", lambda device: int(need / 0.6))
    assert not attack._resolve_pipeline(images, state)
    attack.pipeline_epochs = True
    assert attack._resolve_pipeline(images, state)
