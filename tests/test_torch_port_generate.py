"""The port's batch generation and dataset CLIs against the JAX package's:
``cli.generate.main`` of both packages on the tiny victim with one
dictionary artifact (the JAX package's own test fixture: two JAX ``gd``
epochs on 12 images), on a blob and on a folder of JPEGs (the native
loader's path and PIL's), ``cli.dataset``'s blob read by either package, and
``utils.trace`` and ``utils.key_seq``.

The port's victim takes the JAX victim's weights through ``--weights``.
Tolerances, supervised: the same total, the same per-batch rows and fooling
counts, per-batch mse within 5e-5 relative (1.3e-5 here, with the
adversaries 5e-7 apart: DDrague's first AdamW steps on entries of z with
gradients near AdamW's eps, as ``test_torch_port_harness`` explains for its
5e-5), and the same PNG names with at
least 99.9% of the bytes equal and none more than 1 apart (the uint8
truncation of a float32 product can flip at a tie). Unsupervised codes are
drawn by each package's own generator, so there the report's shape and the
budget are checked, and one ``fused_perturb`` call per trial.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.attacks import ADIL as JaxADIL
from dl_attack_on_imagenet_tpu.cli import dataset as jax_dataset
from dl_attack_on_imagenet_tpu.cli import generate as jax_generate
from dl_attack_on_imagenet_tpu.data import ArrayDataset as JaxArrayDataset
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core
from dl_attack_on_imagenet_tpu_torch.cli import dataset, generate

from _torch_port import victim_pair

RTOL = 5e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dictionary artifact, the port's weights file for the JAX victim
    of seed 0, and the 12 images the dictionary was learned on."""
    root = tmp_path_factory.mktemp("gen")
    victim = jax_create_model("tiny", rng=jax.random.PRNGKey(0))
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (12, 32, 32, 3)))
    JaxADIL(victim, steps=2, n_atoms=4, batch_size=6,
            data_train=JaxArrayDataset(x, np.zeros(12, np.int64)),
            cache=JaxArtifactCache(str(root / "dicts")), model_name="tiny")
    _, _, pv = victim_pair("tiny", key=0)
    weights = str(root / "tiny.pt")
    torch.save(pv.net.state_dict(), weights)
    return str(root / "dicts"), weights, x.astype(np.float32)


def _run_both(setup, tmp_path, args):
    dicts, weights, _ = setup
    common = ["--model", "tiny", "--dict-dir", dicts, "--steps-inference", "3"] + args
    want = jax_generate.main(jax_generate.build_argparser().parse_args(
        common + ["--out-dir", str(tmp_path / "jax")]))
    got = generate.main(generate.build_argparser().parse_args(
        common + ["--out-dir", str(tmp_path / "port"), "--weights", weights, "--device", "cpu"]))
    return got, want


def _report(path):
    with open(os.path.join(path, "report.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_reports_match(tmp_path, got, want):
    assert got["total"] == want["total"]
    assert got["fooling_rate"] == pytest.approx(want["fooling_rate"], abs=1e-12)
    rep_got, rep_want = _report(tmp_path / "port"), _report(tmp_path / "jax")
    assert [(r["step"], r["n"]) for r in rep_got] == [(r["step"], r["n"]) for r in rep_want]
    assert [round(r["fooling"] * r["n"]) for r in rep_got] == \
        [round(r["fooling"] * r["n"]) for r in rep_want]
    np.testing.assert_allclose([r["mse"] for r in rep_got], [r["mse"] for r in rep_want],
                               rtol=RTOL, atol=0)
    with open(tmp_path / "port" / "summary.json") as f:
        assert json.load(f) == got


def _assert_pngs_match(tmp_path):
    from PIL import Image

    names = sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(tmp_path / "jax") if f.endswith(".png"))
    a = np.stack([np.asarray(Image.open(tmp_path / "port" / n)) for n in names]).astype(int)
    b = np.stack([np.asarray(Image.open(tmp_path / "jax" / n)) for n in names]).astype(int)
    assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1
    return names


def test_argparser_keeps_the_jax_options_and_defaults():
    def defaults(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    got, want = defaults(generate.build_argparser()), defaults(jax_generate.build_argparser())
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"] == "cuda" and got["batch_size"] == 128
    assert defaults(dataset.build_argparser()) == defaults(jax_dataset.build_argparser())


def test_supervised_blob_matches_jax(setup, tmp_path):
    # 10 of the 12 images at batch 6: a full batch and a short one of 4.
    blob = str(tmp_path / "b.npz")
    dataset.save_blob(blob, setup[2], np.zeros(12), ["a"])
    got, want = _run_both(setup, tmp_path, ["--blob", blob, "--batch-size", "6", "--limit", "10",
                                            "--save-images"])
    assert got["total"] == 10 and [r["n"] for r in _report(tmp_path / "port")] == [6, 4]
    _assert_reports_match(tmp_path, got, want)
    assert _assert_pngs_match(tmp_path) == [f"adv_{i:06d}.png" for i in range(10)]


def test_unsupervised_blob_runs_one_launch_a_trial(setup, tmp_path, monkeypatch):
    # The CLI builds ADIL with its default 100 atoms, which the sampler
    # draws codes for: a dictionary of 100 atoms.
    blob = str(tmp_path / "b.npz")
    dataset.save_blob(blob, setup[2], np.zeros(12), ["a"])
    dicts = str(tmp_path / "dicts100")
    d = np.random.RandomState(5).uniform(-1.0, 1.0, (100, 32, 32, 3)).astype(np.float32)
    JaxArtifactCache(dicts).save({"d": d}, "ImageNet", model="tiny")
    setup = (dicts,) + setup[1:]
    calls = []
    real = adil_core.fused_perturb

    def counting(v, d, x, eps):
        calls.append(eps)
        return real(v, d, x, eps)

    monkeypatch.setattr(adil_core, "fused_perturb", counting)
    got, want = _run_both(setup, tmp_path, ["--blob", blob, "--batch-size", "6",
                                            "--mode", "unsupervised", "--save-images"])
    assert got["total"] == want["total"] == 12
    assert calls == [8 / 255] * 20  # 10 trials a batch, each clamped to eps
    rep = _report(tmp_path / "port")
    assert [(r["step"], r["n"]) for r in rep] == [(0, 6), (6, 6)]
    assert all(0.0 <= r["fooling"] <= 1.0 for r in rep)
    assert all(r["mse"] <= 32 * 32 * 3 * (8 / 255) ** 2 + 1e-6 for r in rep)
    from PIL import Image

    adv = np.stack([np.asarray(Image.open(tmp_path / "port" / f"adv_{i:06d}.png"))
                    for i in range(12)]) / 255.0
    assert np.abs(adv - setup[2]).max() <= 8 / 255 + 1 / 255


def _jpeg_tree(root, n=5):
    from PIL import Image

    val = root / "ImageNet" / "ILSVRC" / "Data" / "val" / "n00000001"
    val.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((40, 40, 3)) * 255).astype(np.uint8)).save(val / f"{i}.JPEG")
    return str(root / "ImageNet")


@pytest.mark.parametrize("native", [True, False])
def test_folder_matches_jax(setup, tmp_path, monkeypatch, native):
    # 5 JPEGs at batch 6: the native path cycles them to 6 rows, PIL's runs 5.
    if not native:
        import dl_attack_on_imagenet_tpu.runtime as jax_runtime
        import dl_attack_on_imagenet_tpu_torch.runtime as port_runtime

        monkeypatch.setattr(jax_runtime, "get_runtime", lambda: None)
        monkeypatch.setattr(port_runtime, "get_runtime", lambda: None)
    root = _jpeg_tree(tmp_path)
    got, want = _run_both(setup, tmp_path, ["--data-root", root, "--batch-size", "6",
                                            "--limit", "5", "--save-images"])
    assert got["total"] == 5
    _assert_reports_match(tmp_path, got, want)
    assert len(_assert_pngs_match(tmp_path)) == 5


def test_dataset_blobs_load_in_either_package(tmp_path):
    root = _jpeg_tree(tmp_path, n=3)
    paths = {}
    for name, cli in (("port", dataset), ("jax", jax_dataset)):
        paths[name] = str(tmp_path / f"{name}.npz")
        assert cli.main(cli.build_argparser().parse_args(
            ["--root", root, "--out", paths[name], "--image-size", "32"])) == paths[name]
    for path in paths.values():
        got, got_classes = dataset.load_blob(path)
        want, want_classes = jax_dataset.load_blob(path)
        assert got.images.dtype == np.float32 and got.labels.dtype == np.int64
        assert got.images.shape == (3, 32, 32, 3) and got_classes == want_classes == ["n00000001"]
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    port, jax_blob = dataset.load_blob(paths["port"])[0], dataset.load_blob(paths["jax"])[0]
    np.testing.assert_array_equal(port.images, jax_blob.images)  # one native decoder


def test_trace_writes_a_chrome_trace_and_key_seq_is_seeded(tmp_path):
    # The utilities the CLIs export beside generate: utils.trace (a no-op
    # for None) and utils.key_seq (the JAX package's key_seq over seeds).
    from dl_attack_on_imagenet_tpu_torch.utils import annotate, key_seq, trace

    with trace(None):
        pass
    with trace(str(tmp_path / "t")), annotate("generate/batch"):
        torch.ones(4) @ torch.ones(4)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "generate/batch" for e in events)
    draws = [[float(torch.rand((), generator=g)) for g in (next(s) for _ in range(3))]
             for s in (key_seq(0, "cpu"), key_seq(0, "cpu"), key_seq(1, "cpu"))]
    assert draws[0] == draws[1] != draws[2] and len(set(draws[0])) == 3
