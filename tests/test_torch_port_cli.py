"""The port's CLI layer against the JAX package's: the argparsers, the victim
builder (``--weights``, ``--fast-victim``'s BatchNorm fold), ``cli.demo``'s
experiment on the same images, weights and dictionary, and ``cli.main``'s
figure. The dictionary is one artifact that both packages read from one
cache directory, so neither trains where the two are compared.

Tolerances: the fold within 1e-5 of the unfolded logits (the same fp32
products, scaled before rather than after); ``--weights`` within 1e-4 of
the JAX victim (the ResNet parity tolerance of ``test_torch_port_models``);
the experiment's accuracy and fooling rates exactly equal, RMSE and MSE
within 5e-5 relative (see ``test_torch_port_harness`` for why not 1e-5)."""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.cli import demo as jax_demo
from dl_attack_on_imagenet_tpu.cli import main as jax_main
from dl_attack_on_imagenet_tpu.models import create_model as jax_create_model
from dl_attack_on_imagenet_tpu.models import fast_victim_kwargs as jax_fast_victim_kwargs
from dl_attack_on_imagenet_tpu.models.convert import jax_tree_to_numpy
from dl_attack_on_imagenet_tpu.models.convert import load_torch_checkpoint as jax_load_checkpoint
from dl_attack_on_imagenet_tpu_torch.cli import demo, main
from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
from dl_attack_on_imagenet_tpu_torch.models import create_model, fast_victim_kwargs
from dl_attack_on_imagenet_tpu_torch.models.convert import state_dict_from_flax
from dl_attack_on_imagenet_tpu_torch.models.fold import fold_victim
from dl_attack_on_imagenet_tpu_torch.ops import kernels
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache, load_artifact

from _torch_port import t, victim_pair

RTOL = 5e-5


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax_mod", [(main, jax_main), (demo, jax_demo)])
def test_argparsers_keep_the_jax_options_and_defaults(port, jax_mod):
    got, want = _defaults(port.build_argparser()), _defaults(jax_mod.build_argparser())
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"] == "cuda"
    args = port.build_argparser().parse_args(["--model", "resnet18", "--weights", "w.pth",
                                              "--fast-victim", "--device", "cpu"])
    assert args.weights == "w.pth" and args.fast_victim and args.device == "cpu"


@pytest.mark.parametrize("name", ["resnet50", "resnet18", "googlenet", "densenet121",
                                  "inception_v3", "mobilenet_v2", "vgg11", "vit_b16", "tiny"])
def test_fast_victim_kwargs_are_the_jax_mapping(name):
    assert fast_victim_kwargs(name) == jax_fast_victim_kwargs(name)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_fold_matches_the_unfolded_logits(name):
    _, _, pv = victim_pair(name, input_size=64, seed=5)  # BatchNorms randomized
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    want = pv(x)
    unfolded = {k: v.clone() for k, v in pv.net.state_dict().items()}
    folded = fold_victim(pv)  # in place
    assert folded is pv
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    assert folded.net.conv1.bias is not None and folded.norm is not None
    np.testing.assert_allclose(folded(x).numpy(), want.numpy(), atol=1e-5, rtol=0)
    keys = folded.net.state_dict().keys()
    assert {"conv1.bias", "layer2.0.downsample.0.bias", "fc.weight"} <= keys
    assert not any(k.startswith("bn1.") or "running_var" in k for k in keys)
    built = create_model(name, input_size=64, device="cpu", state_dict=unfolded, fold_bn=True)
    np.testing.assert_array_equal(built(x).numpy(), folded(x).numpy())
    with pytest.raises(ValueError, match="no folded form"):
        create_model("tiny", device="cpu", fold_bn=True)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A torchvision-format resnet18 state_dict (torchvision's names and
    order) of a JAX victim with randomized BatchNorms."""
    _, _, pv = victim_pair("resnet18", input_size=64, seed=7, key=7)
    path = str(tmp_path_factory.mktemp("w") / "resnet18.pth")
    torch.save({k: v.contiguous() for k, v in pv.net.state_dict().items()}, path)
    x = np.random.RandomState(3).uniform(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    return path, x


def _victim_args(**kw):
    ns = dict(model="resnet18", seed=11, input_size=64, fast_victim=False, weights=None,
              device="cpu")
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("fast", [False, True])
def test_weights_give_the_jax_checkpoints_logits(checkpoint, capsys, fast):
    path, x = checkpoint
    want = np.asarray(jax_load_checkpoint(
        path, jax_create_model("resnet18", rng=jax.random.PRNGKey(11), input_size=64))(x))
    victim = build_victim(_victim_args(weights=path, fast_victim=fast))
    assert victim.device.type == "cpu" and victim.input_size == 64
    assert any(isinstance(m, torch.nn.BatchNorm2d) for m in victim.modules()) != fast
    np.testing.assert_allclose(victim(t(x)).numpy(), want, atol=1e-4, rtol=0)
    assert ("stem_s2d" in capsys.readouterr().out) == fast  # dropped, and said so


def test_build_victim_names_what_is_not_ported():
    with pytest.raises(ValueError, match="not ported yet .ROADMAP.md queue 1 item 7"):
        build_victim(_victim_args(model="mobilenet"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_victim(_victim_args(device="cuda"))


SYNTH = ["--synthetic", "24", "--seed", "14", "--steps", "2", "--n-atoms", "4",
         "--steps-inference", "10", "--batch-size", "8", "--eps", "0.3"]


def test_run_experiment_matches_the_jax_demo(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    dicts = str(tmp_path / "dicts")
    d = np.random.RandomState(0).uniform(-1.0, 1.0, (4, 32, 32, 3)).astype(np.float32)
    ArtifactCache(dicts).save({"d": d}, "ImageNet", model="tiny")
    common = SYNTH + ["--dict-dir", dicts]
    want = jax_demo.main(jax_demo.build_argparser().parse_args(
        common + ["--results-dir", str(tmp_path / "jax")]))

    # JAX's --synthetic images and victim, carried over.
    rng = jax.random.PRNGKey(14)
    jv = jax_create_model("tiny", rng=rng)
    images = np.asarray(jax.random.uniform(rng, (24, 32, 32, 3)))
    victim = create_model("tiny", device="cpu",
                          state_dict=state_dict_from_flax(jax_tree_to_numpy(jv.variables)))
    args = demo.build_argparser().parse_args(common + ["--results-dir", str(tmp_path / "port"),
                                                       "--device", "cpu"])
    got = demo.run_experiment(victim, ArrayDataset(images, np.arange(24) % 4), 4, [2, 1, 1],
                              "tiny", args)

    assert got["accuracy"] == want["accuracy"] == 0.25
    for split in ("val", "test"):
        g, w = got[split], want[split]
        assert g["group_key"] == w["group_key"] and g["sub_names"] == w["sub_names"]
        key = w["group_key"]["adil"]
        assert g["fooling_rate"][key] == w["fooling_rate"][key]
        np.testing.assert_allclose(g["rmse"][key], w["rmse"][key], rtol=RTOL, atol=0)
        np.testing.assert_allclose(g["mse"][key], w["mse"][key], rtol=RTOL, atol=0)
        assert g["mse"][key][0] > 0  # the kept row was attacked
    name = "results_tiny_seed14.msgpack"
    got_file = load_artifact(str(tmp_path / "port" / name))
    want_file = load_artifact(str(tmp_path / "jax" / name))
    assert sorted(got_file) == sorted(want_file)
    assert got_file["accuracy"] == want_file["accuracy"]
    assert not ArtifactCache(dicts).exists("ImageNet", model="tiny", kind="train_state_torch")


def test_demo_main_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = demo.build_argparser().parse_args(
        SYNTH + ["--device", "cpu", "--dict-dir", str(tmp_path / "dicts"),
                 "--results-dir", str(tmp_path / "results")])
    results = demo.main(args)
    assert 0.0 <= results["accuracy"] <= 1.0
    key = results["val"]["group_key"]["adil"]
    assert len(results["val"]["fooling_rate"][key]) == 1
    saved = ArtifactCache(str(tmp_path / "dicts")).load("ImageNet", model="tiny")
    assert saved["d"].shape == (4, 32, 32, 3) and len(saved["loss"]) == 2  # it trained
    assert os.listdir(tmp_path / "results") == ["results_tiny_seed14.msgpack"]
    assert "stage walls (s): accuracy" in capsys.readouterr().out
    assert kernels.fused_perturb.launches == kernels.fused_adamw_project.launches == 0


@pytest.mark.parametrize("extra,error", [
    (["--synthetic", "8", "--distributed"], "queue 1 item 6"),
    (["--synthetic", "8", "--mixed-precision"], "queue 1 item 2"),
    ([], "not ported yet .ROADMAP.md queue 1 item 7"),  # the default model, densenet
])
def test_demo_names_what_is_not_ported(extra, error):
    args = demo.build_argparser().parse_args(extra + ["--device", "cpu"])
    with pytest.raises((NotImplementedError, ValueError), match=error):
        demo.main(args)


def test_cli_main_draws_a_png(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = main.build_argparser().parse_args(
        ["--model", "tiny", "--steps-inference", "3", "--device", "cpu",
         "--dict-dir", str(tmp_path / "dicts"), "--out", str(tmp_path / "fig.png")])
    out = main.main(args)  # no dictionary yet: ADIL learns one on the image first
    assert out == str(tmp_path / "fig.png") and os.path.getsize(out) > 1000
    assert ArtifactCache(str(tmp_path / "dicts")).exists("ImageNet", model="tiny")


def test_attack_image_reads_a_jpeg_and_a_saved_dictionary(tmp_path, monkeypatch, capsys):
    from PIL import Image

    from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
    from dl_attack_on_imagenet_tpu_torch.data import default_transform

    path = tmp_path / "cat.JPEG"
    Image.fromarray((np.random.default_rng(0).random((45, 70, 3)) * 255).astype(np.uint8)).save(path)
    d = np.random.RandomState(1).uniform(-1.0, 1.0, (100, 32, 32, 3)).astype(np.float32)
    ArtifactCache(str(tmp_path)).save({"d": d}, "ImageNet", model="tiny")
    monkeypatch.setattr(ADIL, "learn_dictionary", lambda *a: pytest.fail("it trained"))
    args = main.build_argparser().parse_args(
        ["--model", "tiny", "--image", str(path), "--steps-inference", "2", "--device", "cpu",
         "--dict-dir", str(tmp_path), "--out", str(tmp_path / "fig.png")])
    x, adv, label, attack_label = main.attack_image(args)
    with Image.open(path) as img:
        np.testing.assert_array_equal(x[0].numpy(), default_transform(img, size=32))
    assert adv.shape == x.shape == (1, 32, 32, 3) and label.shape == attack_label.shape == (1,)
    main.save_figure(args, x, adv, label, attack_label)
    assert "figure:" in capsys.readouterr().out
