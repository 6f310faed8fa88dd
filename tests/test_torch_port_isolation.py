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
    for blocked in ("jax", "jaxlib", "flax", "optax", "msgpack"):
        sys.modules[blocked] = None  # any import of these now raises
    import dl_attack_on_imagenet_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
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
    assert int(out.stdout.split()[-1]) >= 15  # every module was imported


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
