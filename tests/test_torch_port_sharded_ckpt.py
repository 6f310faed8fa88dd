"""The port's sharding-aware checkpoint on ``torch.distributed.checkpoint``
(DCP): ``ArtifactCache.save_sharded``/``load_sharded`` and
``learn_dictionary_distributed(ckpt_sharded=True)``, the counterparts of the
JAX package's orbax collective saves.

- In one process, the collective methods round-trip nested tensors, and a
  save killed before or between its renames leaves the last checkpoint
  whole and resumable (``.old``).
- At two gloo ranks (``_torch_port_dp_worker.py ... sharded``), a run
  killed after its second checkpoint and resumed equals the whole run bit
  for bit (D, v and the history), with ``ckpt_sharded=True`` and with
  False; the sharded one gathers nothing before its return
  (``_gather_rows`` raises until then), its directory holds v in two row
  chunks, one a rank, and one D equal to each rank's; and it agrees with
  the JAX package's sharded resume on a two-device mesh within 1e-5 (the
  same D, v and weights; one batch an epoch, so that the two packages'
  plans hold the same rows).
- ``ckpt_sharded="auto"`` takes the rank-0 msgpack checkpoint in a world of
  one process and the sharded one at two ranks.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu import parallel as jpar
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.data import ArrayDataset as JaxArrayDataset
from dl_attack_on_imagenet_tpu.parallel import adil_dp as jdp
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks.adil_core import AdilConfig
from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp, auto_initialize, data_mesh
from dl_attack_on_imagenet_tpu_torch.parallel import dist as port_dist
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache
from dl_attack_on_imagenet_tpu_torch.utils import checkpoint

from _torch_port import victim_pair
from _torch_port_dp_worker import SHARDED_KEY, Killed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMG, K, SIZE, N_DEV, STEPS = 7, 4, 32, 2, 4  # 7 rows: the second shard is padded
N_LOCAL = -(-N_IMG // N_DEV)
BATCH = N_LOCAL * N_DEV  # one batch an epoch


# -- the collective methods in one process --------------------------------

def test_sharded_methods_in_one_process(tmp_path):
    # Without a process group the collective methods run as one process.
    cache = ArtifactCache(str(tmp_path))
    tree = {"d": torch.rand(3, 5), "meta": {"epoch": torch.tensor(2),
                                            "loss": torch.zeros(4, dtype=torch.float64)}}
    assert cache.load_sharded(tree, "ImageNet", model="x") is None
    p = cache.save_sharded(tree, "ImageNet", model="x")
    assert p.endswith("ImageNet_model_x.dcp_sharded")
    assert cache.exists_sharded("ImageNet", model="x")
    template = {"d": torch.zeros(3, 5), "meta": {"epoch": torch.tensor(0),
                                                 "loss": torch.ones(4, dtype=torch.float64)}}
    out = cache.load_sharded(template, "ImageNet", model="x")
    assert out is template
    assert torch.equal(template["d"], tree["d"]) and int(template["meta"]["epoch"]) == 2
    assert torch.equal(template["meta"]["loss"], tree["meta"]["loss"])
    with pytest.raises(ValueError, match="'d' was saved as torch.Size.*only at the shapes"):
        cache.load_sharded({"d": torch.zeros(4, 5), "meta": template["meta"]}, "ImageNet",
                           model="x")
    cache.remove_sharded("ImageNet", model="x")
    assert not cache.exists_sharded("ImageNet", model="x")


def _kill_in_replace(monkeypatch, where):
    """Make the next ``_replace_dir`` die before its first rename or just
    after it (the older directory set aside, the new one not yet moved)."""
    def replace_then_die(src, dst):
        if where == "between_renames":
            os.replace(dst, dst + ".old")
        raise Killed

    monkeypatch.setattr(checkpoint, "_replace_dir", replace_then_die)


@pytest.mark.parametrize("where", ["before_renames", "between_renames"])
def test_a_save_killed_in_its_renames_leaves_the_last_checkpoint(tmp_path, monkeypatch, where):
    cache = ArtifactCache(str(tmp_path))
    first = {"d": torch.rand(3, 5), "meta": {"epoch": torch.tensor(1)}}
    cache.save_sharded(first, "ImageNet", model="x")
    real = checkpoint._replace_dir
    _kill_in_replace(monkeypatch, where)
    with pytest.raises(Killed):
        cache.save_sharded({"d": torch.rand(3, 5), "meta": {"epoch": torch.tensor(2)}},
                           "ImageNet", model="x")
    monkeypatch.setattr(checkpoint, "_replace_dir", real)
    assert cache.exists_sharded("ImageNet", model="x")
    template = {"d": torch.zeros(3, 5), "meta": {"epoch": torch.tensor(0)}}
    cache.load_sharded(template, "ImageNet", model="x")
    assert torch.equal(template["d"], first["d"]) and int(template["meta"]["epoch"]) == 1
    third = {"d": torch.rand(3, 5), "meta": {"epoch": torch.tensor(3)}}
    cache.save_sharded(third, "ImageNet", model="x")  # a later save settles the directory
    assert os.listdir(tmp_path) == ["ImageNet_model_x.dcp_sharded"]
    cache.load_sharded(template, "ImageNet", model="x")
    assert torch.equal(template["d"], third["d"]) and int(template["meta"]["epoch"]) == 3
    _kill_in_replace(monkeypatch, where)
    with pytest.raises(Killed):
        cache.save_sharded(first, "ImageNet", model="x")
    cache.remove_sharded("ImageNet", model="x")  # with what the killed save left
    assert os.listdir(tmp_path) == [] and not cache.exists_sharded("ImageNet", model="x")


@pytest.mark.parametrize("where", ["before_renames", "between_renames"])
def test_dp_resumes_after_a_kill_in_the_renames(tmp_path, monkeypatch, where):
    # learn_dictionary_distributed(ckpt_sharded=True) in a world of one,
    # killed while its second checkpoint is moved into place: the resumed
    # run starts from the first and equals the whole run bit for bit.
    for key in _LAUNCH_KEYS:
        monkeypatch.delenv(key, raising=False)
    victim = create_model("tiny", device="cpu")
    images = np.random.RandomState(0).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    data = ArrayDataset(images, np.zeros(4))
    cfg = AdilConfig(n_atoms=4, batch_size=2, steps=3, loss="logits")
    real, saves = checkpoint._replace_dir, []

    def kill_at_the_second(src, dst):
        saves.append(1)
        if len(saves) == 2:
            _kill_in_replace(monkeypatch, where)
            checkpoint._replace_dir(src, dst)
        real(src, dst)

    auto_initialize(device="cpu")
    try:
        mesh = data_mesh()

        def learn(root):
            return adil_dp.learn_dictionary_distributed(
                victim, data, cfg, mesh, checkpoint_every=1, cache=ArtifactCache(root),
                ckpt_sharded=True)

        whole = learn(str(tmp_path / "whole"))
        monkeypatch.setattr(checkpoint, "_replace_dir", kill_at_the_second)
        with pytest.raises(Killed):
            learn(str(tmp_path / "resumed"))
        monkeypatch.setattr(checkpoint, "_replace_dir", real)
        restored = []
        real_restore = adil_dp._ckpt_restore_sharded
        monkeypatch.setattr(adil_dp, "_ckpt_restore_sharded", lambda cache, key, state, *a: (
            real_restore(cache, key, state, *a), restored.append(state.epoch))[0])
        resumed = learn(str(tmp_path / "resumed"))
    finally:
        port_dist.shutdown()
    assert restored == [1]  # from the first checkpoint
    assert torch.equal(resumed[0], whole[0]) and torch.equal(resumed[1], whole[1])
    assert resumed[2]["loss"] == whole[2]["loss"]
    assert os.listdir(tmp_path / "resumed") == []


# -- the sharded DP checkpoint at two gloo ranks ----------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_sharded_resume(jv, inputs, root):
    """The JAX package's sharded kill-and-resume on a two-device mesh from
    the same D and v: (D, v, losses) of the resumed run."""
    cfg = jcore.AdilConfig(n_atoms=K, batch_size=BATCH, steps=STEPS, loss="ce")
    data = JaxArrayDataset(inputs["images"], np.zeros(N_IMG, np.int64))
    mesh = jpar.data_mesh(N_DEV)
    real_codes, real_save = jdp.core.init_codes, jdp._ckpt_save_sharded
    saves = []

    def save_then_kill(*args):
        real_save(*args)
        saves.append(1)
        if len(saves) == 2:
            raise KeyboardInterrupt

    def run():
        return jdp.learn_dictionary_distributed(
            jv, data, cfg, mesh, seed=0, d_init=inputs["d"], checkpoint_every=1,
            cache=JaxArtifactCache(str(root)), ckpt_key=SHARDED_KEY, ckpt_sharded=True)

    jdp.core.init_codes = lambda *args, **kwargs: jnp.asarray(inputs["v"])
    try:
        jdp._ckpt_save_sharded = save_then_kill
        try:
            run()
        except KeyboardInterrupt:
            pass
        finally:
            jdp._ckpt_save_sharded = real_save
        d, v, history = run()
    finally:
        jdp.core.init_codes = real_codes
    return np.asarray(d), np.asarray(v), history["loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two gloo ranks' results (one dict a rank), and the JAX package's
    sharded resume, computed while the ranks run."""
    jv, variables, pv = victim_pair("tiny", key=7)
    rs = np.random.RandomState(0)
    jcfg = jcore.AdilConfig(n_atoms=K)
    inputs = dict(
        images=rs.uniform(0.0, 1.0, (N_IMG, SIZE, SIZE, 3)).astype(np.float32),
        d=np.asarray(jcore.init_dictionary(jax.random.PRNGKey(1), (SIZE, SIZE, 3), jcfg)),
        v=np.asarray(jcore.init_codes(jax.random.PRNGKey(2), N_LOCAL * N_DEV, jcfg,
                                      "distributed")),
        k=K, batch=BATCH, steps=STEPS)
    root = tmp_path_factory.mktemp("sharded")
    np.savez(root / "inputs.npz", **inputs)
    torch.save(pv.net.state_dict(), root / "tiny.pt")
    env = {**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(N_DEV), "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_port_dp_worker.py"), str(root),
         "sharded"], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(N_DEV)]
    try:
        jax_out = _jax_sharded_resume(dataclasses.replace(jv, variables=variables), inputs,
                                      root / "jax")
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(N_DEV)], jax_out


@pytest.mark.parametrize("tag", ["sharded", "msgpack"])
def test_kill_and_resume_at_two_ranks_equals_the_whole_run(runs, tag):
    ranks, _ = runs
    for out in ranks:
        assert out["whole_loss"].shape == (STEPS,)
        for key in ("d", "v", "loss", "fooling"):
            np.testing.assert_array_equal(out[f"{tag}_resumed_{key}"], out[f"whole_{key}"],
                                          err_msg=key)
        assert not out[f"{tag}_left"]  # removed at the end
    for key in ("whole_d", "whole_v", f"{tag}_resumed_loss"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    assert ranks[0]["whole_v"].shape == (N_IMG, K)


def test_auto_takes_the_sharded_checkpoint_at_two_ranks(runs):
    ranks, _ = runs
    for out in ranks:
        assert out["auto_took"].tolist() == ["_ckpt_save_sharded"]


def test_sharded_save_gathers_nothing_and_writes_each_ranks_rows(runs):
    # _gather_rows raised in the workers until the checkpoint was removed,
    # so reaching here means no checkpoint gathered v.
    ranks, _ = runs
    out = ranks[0]
    assert int(out["sharded_dir_epoch"]) == 2
    np.testing.assert_array_equal(out["sharded_dir_v_chunks"][np.argsort(
        out["sharded_dir_v_chunks"][:, 0])], [[0, N_LOCAL], [N_LOCAL, N_LOCAL]])
    np.testing.assert_array_equal(out["sharded_dir_v"], np.concatenate(
        [r["sharded_kill_v"] for r in ranks]))
    for r in ranks:  # one D, equal to every rank's, and every rank reads it back
        np.testing.assert_array_equal(out["sharded_dir_d"], r["sharded_kill_d"])
        np.testing.assert_array_equal(r["sharded_restored_d"], out["sharded_dir_d"])


def test_sharded_resume_matches_the_jax_package(runs):
    ranks, (d, v, losses) = runs
    np.testing.assert_allclose(ranks[0]["sharded_resumed_d"], d, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["sharded_resumed_v"], v, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["sharded_resumed_loss"], losses, rtol=1e-5)


# -- the "auto" rule in a world of one ----------------------------------------

_LAUNCH_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
                "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NODELIST")


def test_auto_takes_the_msgpack_checkpoint_in_a_world_of_one(tmp_path, monkeypatch):
    for key in _LAUNCH_KEYS:
        monkeypatch.delenv(key, raising=False)
    victim = create_model("tiny", device="cpu")
    images = np.random.RandomState(0).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    data = ArrayDataset(images, np.zeros(4))
    cfg = AdilConfig(n_atoms=4, batch_size=4, steps=1, loss="logits")
    took = []
    for name in ("_ckpt_save", "_ckpt_save_sharded"):
        real = getattr(adil_dp, name)
        monkeypatch.setattr(adil_dp, name, lambda *a, _n=name, _r=real: took.append(_n) or _r(*a))
    auto_initialize(device="cpu")
    try:
        adil_dp.learn_dictionary_distributed(victim, data, cfg, data_mesh(), checkpoint_every=1,
                                             cache=ArtifactCache(str(tmp_path)))
    finally:
        port_dist.shutdown()
    assert took == ["_ckpt_save"]


def test_sharded_resume_refuses_another_world_size(tmp_path, monkeypatch):
    # A checkpoint written by two ranks (its meta says so; the shapes of
    # this world of one match) is refused, not resharded.
    for key in _LAUNCH_KEYS:
        monkeypatch.delenv(key, raising=False)
    victim = create_model("tiny", device="cpu")
    images = np.random.RandomState(0).uniform(size=(4, 32, 32, 3)).astype(np.float32)
    data = ArrayDataset(images, np.zeros(4))
    cfg = AdilConfig(n_atoms=4, batch_size=4, steps=2, loss="logits")
    cache = ArtifactCache(str(tmp_path))
    real_meta, real_save = adil_dp._meta, adil_dp._ckpt_save_sharded

    def save_as_two_ranks_then_kill(*args):
        monkeypatch.setattr(adil_dp, "_meta", lambda *a: {**real_meta(*a),
                                                         "world": torch.tensor(2)})
        real_save(*args)
        raise KeyboardInterrupt

    auto_initialize(device="cpu")
    try:
        mesh = data_mesh()
        kw = dict(checkpoint_every=1, cache=cache, ckpt_sharded=True)
        monkeypatch.setattr(adil_dp, "_ckpt_save_sharded", save_as_two_ranks_then_kill)
        with pytest.raises(KeyboardInterrupt):
            adil_dp.learn_dictionary_distributed(victim, data, cfg, mesh, **kw)
        monkeypatch.setattr(adil_dp, "_meta", real_meta)
        monkeypatch.setattr(adil_dp, "_ckpt_save_sharded", real_save)
        with pytest.raises(ValueError, match="written by 2 ranks, not 1"):
            adil_dp.learn_dictionary_distributed(victim, data, cfg, mesh, **kw)
    finally:
        port_dist.shutdown()
