"""Keyword arguments that a caller of the JAX package passes, accepted by
the port with the JAX package's meaning: ``learn_dictionary_distributed(
ckpt_sharded=)`` ("auto" in a world of one process and False are the
rank-0 msgpack checkpoint, True the collective DCP one, the counterpart of
the JAX package's orbax checkpoint), ``fold_victim(victim, normalize=)``,
``load_torch_checkpoint(path, victim, vit=)`` and ``get_runtime(build=)``;
and the CLIs' ``build_victim(args, dtype=)``.
"""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.models import fold as jfold
from dl_attack_on_imagenet_tpu.models.convert import load_torch_checkpoint as jax_load
from dl_attack_on_imagenet_tpu.parallel import adil_dp as jdp
from dl_attack_on_imagenet_tpu.runtime import host_loader as jhost
from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig
from dl_attack_on_imagenet_tpu_torch.cli import main
from dl_attack_on_imagenet_tpu_torch.cli._victim import build_victim
from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.models.convert import load_torch_checkpoint
from dl_attack_on_imagenet_tpu_torch.models.fold import fold_victim
from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp, auto_initialize, data_mesh
from dl_attack_on_imagenet_tpu_torch.parallel import dist as port_dist
from dl_attack_on_imagenet_tpu_torch.runtime import host_loader
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t
from test_torch_port_zoo import zoo_pair

_ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
             "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NODELIST")


def _defaults(fn, name):
    return inspect.signature(fn).parameters[name].default


def test_ckpt_sharded_takes_the_msgpack_path_and_refuses_orbax(tmp_path, monkeypatch):
    # "auto" (in a world of one) and False take the rank-0 msgpack
    # checkpoint, True the collective DCP one, the counterpart of the JAX
    # package's orbax checkpoint; all three learn the same D. The orbax
    # backend itself stays refused, naming msgpack and ckpt_sharded=True.
    assert _defaults(adil_dp.learn_dictionary_distributed, "ckpt_sharded") == _defaults(
        jdp.learn_dictionary_distributed, "ckpt_sharded") == "auto"
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    victim = create_model("tiny", device="cpu")
    images = np.random.RandomState(0).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    data = ArrayDataset(images, np.zeros(4))
    cfg = AdilConfig(n_atoms=4, batch_size=4, steps=1, loss="logits")
    saves = []
    for name in ("_ckpt_save", "_ckpt_save_sharded"):
        real = getattr(adil_dp, name)
        monkeypatch.setattr(adil_dp, name, lambda cache, *a, _n=name, _r=real: saves.append(
            (_n, cache.root)) or _r(cache, *a))
    auto_initialize(device="cpu")
    try:
        mesh = data_mesh()
        runs = {}
        for flag, path in (("auto", "_ckpt_save"), (False, "_ckpt_save"),
                           (True, "_ckpt_save_sharded")):
            root = str(tmp_path / str(flag))
            d, _, history = adil_dp.learn_dictionary_distributed(
                victim, data, cfg, mesh, checkpoint_every=1, cache=ArtifactCache(root),
                ckpt_sharded=flag)
            assert saves[-1] == (path, root)
            assert os.listdir(root) == []  # removed at the end
            runs[flag] = (d, history["loss"])
    finally:
        port_dist.shutdown()
    for flag in (False, True):
        assert torch.equal(runs["auto"][0], runs[flag][0]) and runs["auto"][1] == runs[flag][1]
    with pytest.raises(NotImplementedError,
                       match='only orbax.*use backend="msgpack".*ckpt_sharded=True'):
        ArtifactCache(str(tmp_path), backend="orbax")


def test_fold_victim_takes_normalize():
    assert _defaults(fold_victim, "normalize") is _defaults(jfold.fold_victim, "normalize") is None
    jv, pv = zoo_pair("resnet18", 32, seed=1)
    x = np.random.RandomState(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jfold.fold_victim(jv, normalize=False)(jnp.asarray(x)))
    folded = fold_victim(pv, normalize=False)
    assert folded.norm is None
    np.testing.assert_allclose(folded(t(x)).numpy(), want, atol=1e-4, rtol=0)
    assert fold_victim(folded, normalize=True).norm is not None  # back on
    kept = fold_victim(create_model("resnet18", input_size=32, device="cpu"))
    assert kept.norm is not None  # None keeps it


def test_load_torch_checkpoint_takes_vit(tmp_path):
    assert _defaults(load_torch_checkpoint, "vit") is _defaults(jax_load, "vit") is False
    source = create_model("vit_tiny", input_size=32, device="cpu", seed=3)
    torch.save(source.net.state_dict(), tmp_path / "vit.pth")
    x = torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    for vit in (False, True):
        victim = load_torch_checkpoint(str(tmp_path / "vit.pth"),
                                       create_model("vit_tiny", input_size=32, device="cpu",
                                                    seed=4), vit=vit)
        assert torch.equal(victim(x), source(x))


@pytest.mark.parametrize("dtype,want", [(None, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_build_victim_takes_dtype(dtype, want):
    args = main.build_argparser().parse_args(["--model", "tiny", "--device", "cpu",
                                              "--fast-victim"])
    victim = build_victim(args, dtype=dtype)
    assert victim.dtype == want
    assert victim(torch.rand((1, 32, 32, 3))).dtype == want
    assert all(p.dtype == torch.float32 for p in victim.parameters())


def test_get_runtime_build_false_loads_only_a_built_library(tmp_path, monkeypatch):
    assert _defaults(host_loader.get_runtime, "build") is _defaults(jhost.get_runtime,
                                                                    "build") is True
    monkeypatch.setattr(host_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_loader, "_runtime", None)
    monkeypatch.setattr(host_loader, "_tried", False)
    monkeypatch.setattr(host_loader, "build_error", None)
    built = []
    monkeypatch.setattr(host_loader, "build", lambda: built.append(1))
    assert host_loader.get_runtime(build=False) is None
    assert not built and "get_runtime(build=False) builds nothing" in host_loader.build_error
    assert host_loader.get_runtime() is None and not built  # the first call decided, as in JAX
