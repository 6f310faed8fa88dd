"""The port's evaluation harness against the JAX package's, on the tiny victim
with the same weights and one dictionary artifact that both packages read
from one cache directory (so neither trains): accuracy and fooling counts
exactly equal, RMSE and MSE within 5e-5 relative.

Why 5e-5 and not 1e-5: DDrague's first AdamW step moves each entry of z by
about ``lr * g / (|g| + 1e-8)``. About 2% of z's entries here have
gradients under 1e-6, where the two frameworks' fp32 backward passes
(6.6e-7 apart, relative to the largest gradient) give steps up to 8.6e-6
apart. Those entries project onto the dictionary's span, and after 5 steps
the summed squared perturbation differs by about 1.5e-5 relative. The
contractions themselves (pseudo-inverse, codes, D·v) agree to 7e-7."""

import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import evaluation as jev
from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch import evaluation as ev
from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import victim_pair

K, SIZE = 8, 32
EPS_GRID = [0.01, 0.05, 0.3]
RTOL = 5e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jv, _, pv = victim_pair("tiny", key=14)  # weights the attack can fool
    rs = np.random.RandomState(11)
    images = rs.uniform(0.0, 1.0, (12, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.asarray(jv.predict(images)).astype(np.int64)
    labels[[1, 6, 7]] = (labels[[1, 6, 7]] + 1) % 10  # misclassified rows are left out
    root = str(tmp_path_factory.mktemp("dicts"))
    d = rs.uniform(-1.0, 1.0, (K, SIZE, SIZE, 3)).astype(np.float32)
    ArtifactCache(root).save({"d": d}, "ImageNet", model="shared")
    loader = [(images[s:s + 5], labels[s:s + 5]) for s in range(0, 12, 5)]  # 5, 5, 2 rows
    return jv, pv, root, images, labels, loader


def _grids(setup, eps=EPS_GRID):
    jv, pv, root, *_ = setup
    kw = dict(n_atoms=K, loss="logits", steps_inference=10, model_name="shared")
    want = {"adil": jev.get_atks(jv, JaxADIL, "eps", eps, cache=JaxArtifactCache(root), **kw)}
    got = {"adil": ev.get_atks(pv, ADIL, "eps", eps, cache=ArtifactCache(root), **kw)}
    return got, want


def _assert_perf_equal(got, want):
    assert got.keys() == want.keys()
    assert got["group_key"] == want["group_key"] and got["sub_names"] == want["sub_names"]
    for key in want["fooling_rate"]:
        assert got["fooling_rate"][key] == want["fooling_rate"][key]
        np.testing.assert_allclose(got["rmse"][key], want["rmse"][key], rtol=RTOL, atol=0)
        np.testing.assert_allclose(got["mse"][key], want["mse"][key], rtol=RTOL, atol=0)


@pytest.mark.parametrize("batch_size", [5, 128])
def test_model_accuracy_is_the_jax_one(setup, batch_size):
    jv, pv, _, images, labels, _ = setup
    got = ev.model_accuracy((images, labels), pv, batch_size=batch_size)
    assert got == jev.model_accuracy((images, labels), jv, batch_size=batch_size) == 9 / 12


@pytest.mark.parametrize("args", [(), ("a", [1, 2]), ("a", [1, 2], "b", ["x"], "c", [0.5, 1.5])])
def test_expand_grid_is_the_jax_one(args):
    assert ev.expand_grid(*args) == jev.expand_grid(*args)


def test_get_performance_matches_jax(setup):
    jv, pv, _, _, _, loader = setup
    got_atks, want_atks = _grids(setup)
    got = ev.get_performance(got_atks, pv, loader)
    want = jev.get_performance(want_atks, jv, loader)
    _assert_perf_equal(got, want)
    fooling = want["fooling_rate"][want["group_key"]["adil"]]
    assert fooling[0] < fooling[-1]  # the grid spans a weak and a strong attack


@pytest.mark.parametrize("criterion,budget", [
    ("rmse", [1e-4, 0.05]), ("mse", [0.5, 200.0]), ("fooling_rate", [0.0, 1.0]),
    ("mse_limit", [1e-6, 10.0, 1e4]),
])
def test_select_hyperparameter_matches_jax(setup, criterion, budget):
    jv, pv, _, _, _, loader = setup
    got_atks, want_atks = _grids(setup)
    got_sel, got_perf, got_val = ev.select_hyperparameter(got_atks, pv, loader, budget, criterion)
    want_sel, want_perf, want_val = jev.select_hyperparameter(want_atks, jv, loader, budget,
                                                              criterion)
    _assert_perf_equal(got_val, want_val)
    key = want_val["group_key"]["adil"]
    for g_sel, w_sel, g_perf, w_perf in zip(got_sel, want_sel, got_perf, want_perf):
        assert [got_atks["adil"].index(a) for a in g_sel[key]] == \
               [want_atks["adil"].index(a) for a in w_sel[key]]
        for metric in ("fooling_rate", "rmse", "mse"):
            np.testing.assert_allclose(g_perf[metric][key], w_perf[metric][key], rtol=RTOL)
    if criterion == "mse_limit":
        assert got_sel[0][key] == [] and np.isnan(got_perf[0]["mse"][key])  # none admissible


def test_transfer_performance_matches_jax(setup):
    jv, pv, root, _, _, loader = setup
    jv2, _, pv2 = victim_pair("tiny", key=21)
    got_atks, want_atks = _grids(setup, eps=[0.3])
    got_atks["none"], want_atks["none"] = [], []
    got = ev.get_transfer_performance(got_atks, {"a": pv, "b": pv2}, loader)
    want = jev.get_transfer_performance(want_atks, {"a": jv, "b": jv2}, loader)
    assert got.keys() == want.keys()
    for name in want:
        for vname in ("a", "b"):
            g, w = got[name][vname], want[name][vname]
            if name == "none":
                assert all(np.isnan(g[m]) and np.isnan(w[m]) for m in w)
                continue
            assert g["fooling_rate"] == w["fooling_rate"]
            np.testing.assert_allclose([g["rmse"], g["mse"]], [w["rmse"], w["mse"]], rtol=RTOL)


def test_lazy_attack_learns_on_the_kept_rows_only(setup, tmp_path, monkeypatch):
    _, pv, _, images, labels, _ = setup
    attack = ADIL(pv, n_atoms=K, steps=1, batch_size=4, steps_inference=2,
                  cache=ArtifactCache(str(tmp_path)), model_name="lazy")
    seen = []
    real = attack.learn_dictionary

    def spy(data_train, data_val=None):
        seen.append(np.asarray(data_train[0]))
        real(data_train, data_val)

    monkeypatch.setattr(attack, "learn_dictionary", spy)
    perf = ev.performance(attack, pv, [(images[:5], labels[:5])])  # row 1 is left out
    assert len(seen) == 1 and seen[0].shape[0] == 4
    np.testing.assert_array_equal(seen[0], images[[0, 2, 3, 4]])
    assert perf["num_samples"] == 4 and attack.is_trained
    assert isinstance(ev.performance(attack, pv, [(torch.as_tensor(images[1:2]),
                                                    torch.as_tensor(labels[1:2]))])["mse"], float)
