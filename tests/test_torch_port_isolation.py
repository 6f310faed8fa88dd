"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points do not fall back to the CPU unasked."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from dl_attack_on_imagenet_tpu_torch import resolve_device
from dl_attack_on_imagenet_tpu_torch.models import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_EVERY_MODULE = textwrap.dedent("""
    import importlib, pkgutil, sys
    # Any import of these now raises. PIL and matplotlib may be missing on
    # the card's machine: the port imports them only where it decodes a
    # JPEG or draws a figure.
    for blocked in ("jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "matplotlib"):
        sys.modules[blocked] = None
    import dl_attack_on_imagenet_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for name in ("data.dataset", "data.pipeline", "utils.profiling", "utils.metrics_log",
                 "data.splits", "data.imagenet", "runtime.host_loader", "evaluation.harness",
                 "models.fold", "cli._victim", "cli.demo", "cli.main"):
        assert port.__name__ + "." + name in names, name
    leaked = sorted(m for m in sys.modules
                    if m == "dl_attack_on_imagenet_tpu"
                    or m.startswith("dl_attack_on_imagenet_tpu."))
    assert not leaked, leaked
    print(len(names))
""")


@pytest.mark.parametrize("script", ["package", "chip_smoke"])
def test_port_imports_no_jax_and_nothing_of_the_jax_package(script):
    code = _IMPORT_EVERY_MODULE
    if script == "chip_smoke":
        code += "import chip_smoke\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30  # every module was imported


_CLI_WITHOUT_PIL = textwrap.dedent("""
    import sys
    for blocked in ("jax", "jaxlib", "flax", "PIL", "matplotlib"):
        sys.modules[blocked] = None
    from dl_attack_on_imagenet_tpu_torch.cli import demo, main
    common = ["--device", "cpu", "--steps-inference", "2", "--dict-dir", sys.argv[1]]
    results = demo.main(demo.build_argparser().parse_args(
        ["--synthetic", "16", "--steps", "1", "--n-atoms", "4", "--results-dir", sys.argv[1]]
        + common))
    x, adv, label, attack_label = main.attack_image(main.build_argparser().parse_args(
        ["--model", "tiny"] + common))
    print(results["accuracy"], tuple(adv.shape))
""")


def test_cli_path_runs_without_pil_and_matplotlib(tmp_path):
    # What chip_smoke.py drives on the card: the experiment on arrays and the
    # single-image attack without a JPEG or a figure.
    out = subprocess.run([sys.executable, "-c", _CLI_WITHOUT_PIL, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2].endswith("(1, 32, 32, 3)")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_a_device_where_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
