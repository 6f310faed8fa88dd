"""The port's data parallelism (``parallel/``) against the JAX package's.

Two ranks of the port run over gloo on the CPU in one spawn for the whole
module (``_torch_port_dp_worker.py``); the JAX package runs its
``shard_map`` epoch on a two-device ``data_mesh`` of the virtual CPU mesh.
Both start from the same D, v and weights and follow the same plan of
local batches, drawn by the port.

Tolerances: D within 2e-3 of its learning rate (2e-5) and v within 1e-5,
as in ``test_train_step_matches_jax`` (the same AdamW steps, and the same
reason for D's extra room); the epoch sums within 1e-5 relative; in bf16,
the JAX epoch compiled with ``xla_allow_excess_precision`` off and D and v
within 2^-8 * lr * steps (``test_torch_port_mixed``). The two ranks agree
exactly, a killed and resumed run equals the whole one exactly, and the
sharded accuracy equals the unsharded one exactly. Two data-parallel UAP-PGD
epochs on the two ranks are within 1e-6 of their serial replay and, in e
(l2) and in the losses, within 1e-5 of the JAX package's shard_map epoch.
Two epochs of the data-parallel learning in the space-to-depth layout of a
ResNet-18 with an S2D stem equal their serial replay on the blocked twin
within 1e-5 (3e-6 here: the ranks' D gradients are summed in another order).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dl_attack_on_imagenet_tpu import parallel as jpar
from dl_attack_on_imagenet_tpu.attacks import adil_core as jcore
from dl_attack_on_imagenet_tpu.attacks import uap_pgd as juap
from dl_attack_on_imagenet_tpu.evaluation import model_accuracy as jax_model_accuracy
from dl_attack_on_imagenet_tpu.parallel import adil_dp as jdp
from dl_attack_on_imagenet_tpu.parallel import dist as jdist
from dl_attack_on_imagenet_tpu.utils import ArtifactCache as JaxArtifactCache
from dl_attack_on_imagenet_tpu_torch.attacks import UAPPGD
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.attacks import uap_pgd
from dl_attack_on_imagenet_tpu_torch.cli import demo
from dl_attack_on_imagenet_tpu_torch.evaluation import model_accuracy
from dl_attack_on_imagenet_tpu_torch.models import blocked_twin, depth_to_space, space_to_depth
from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp
from dl_attack_on_imagenet_tpu_torch.parallel import dist as port_dist
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache

from _torch_port import t, victim_pair
from _torch_port_dp_worker import BLOCKED, UAP_KW, blocked_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMG, BATCH, K, SIZE, N_DEV = 7, 4, 8, 32, 2  # 7 rows: the second shard is padded
N_LOCAL = -(-N_IMG // N_DEV)
LR = 0.01
EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def setup():
    jv, variables, pv = victim_pair("tiny")
    rs = np.random.RandomState(0)
    images = rs.uniform(0.0, 1.0, (N_IMG, SIZE, SIZE, 3)).astype(np.float32)
    jcfg = jcore.AdilConfig(n_atoms=K)
    d = np.asarray(jcore.init_dictionary(jax.random.PRNGKey(1), (SIZE, SIZE, 3), jcfg))
    v = np.asarray(jcore.init_codes(jax.random.PRNGKey(2), N_LOCAL * N_DEV, jcfg, "distributed"))
    plan = adil_dp.make_local_batches(torch.Generator().manual_seed(3), N_IMG, N_DEV, BATCH)
    clean = core.predict_labels(pv, t(images)).numpy()
    acc_labels = np.where(np.arange(N_IMG) % 3 == 0, (clean + 1) % 10, clean)  # 3 of 7 wrong
    inputs = dict(images=images, d=d.reshape(K, -1), v=v, plan=plan, acc_labels=acc_labels,
                  k=K, batch=BATCH)
    return jv, variables, pv, inputs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """The two gloo ranks' results, one dict a rank."""
    _, _, pv, inputs = setup
    root = tmp_path_factory.mktemp("dp")
    np.savez(root / "inputs.npz", **inputs)
    torch.save(pv.net.state_dict(), root / "tiny.pt")
    env = {**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(N_DEV), "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_port_dp_worker.py"), str(root)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(N_DEV)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(N_DEV)]


# -- launcher discovery ---------------------------------------------------

_ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
             "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
             "JAX_COORDINATOR_PORT", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
             "SLURM_JOB_NODELIST")
SLURM = {"SLURM_NTASKS": "8", "SLURM_PROCID": "3", "SLURM_LOCALID": "1",
         "SLURM_JOB_NODELIST": "node[001-004,007],other[1-2]"}


@pytest.mark.parametrize("jax_env,port_env", [
    ({}, {}),
    (SLURM, SLURM),
    ({**SLURM, "JAX_COORDINATOR_PORT": "23456"}, {**SLURM, "MASTER_PORT": "23456"}),
    ({"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2", "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
     {"WORLD_SIZE": "4", "RANK": "2", "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}),
    ({**SLURM, "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
      "JAX_COORDINATOR_ADDRESS": "head:99"},
     {**SLURM, "WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "head", "MASTER_PORT": "99"}),
])
def test_distributed_env_matches_jax(monkeypatch, jax_env, port_env):
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in jax_env.items():
        monkeypatch.setenv(key, value)
    want = jdist.distributed_env()
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in port_env.items():
        monkeypatch.setenv(key, value)
    got = port_dist.distributed_env()
    assert (got.coordinator, got.num_processes, got.process_id) == (
        want.coordinator, want.num_processes, want.process_id)
    assert got.is_distributed == want.is_distributed
    assert got.local_rank == int(port_env.get("SLURM_LOCALID", 0))


@pytest.mark.parametrize("nodelist", ["node[001-004,007],other[1-2]", "gpu7", "a,b", "x[5]",
                                      " n[10-12] ", "pre[3-4]post"])
def test_expand_first_host_matches_jax(nodelist):
    assert port_dist.expand_first_host(nodelist) == jdist.expand_first_host(nodelist)


# -- plans ------------------------------------------------------------------

@pytest.mark.parametrize("n_total,n_dev,batch", [(7, 2, 4), (10, 4, 4), (3, 4, 2), (8, 1, 3)])
def test_local_batches_cover_each_shard_once(n_total, n_dev, batch):
    g = torch.Generator().manual_seed(0)
    plan = adil_dp.make_local_batches(g, n_total, n_dev, batch)
    want = jdp.make_local_batches(jax.random.PRNGKey(0), n_total, n_dev, batch)
    assert plan.shape == want.shape
    n_local = -(-n_total // n_dev)
    for p in range(n_dev):
        real = max(min(n_total - p * n_local, n_local), 0)
        rows = plan[p][plan[p] >= 0]
        assert sorted(rows.tolist()) == list(range(real))
        assert (plan[p] == -1).sum() == plan[p].size - real
    # The same generator state draws the same whole plan on every rank.
    again = adil_dp.make_local_batches(torch.Generator().manual_seed(0), n_total, n_dev, batch)
    np.testing.assert_array_equal(plan, again)
    np.testing.assert_array_equal(adil_dp.global_batches_from_local(plan, n_local),
                                  jdp.global_batches_from_local(plan, n_local))


# -- one epoch ----------------------------------------------------------------

def _jax_inputs(setup, mesh, dtype="float32"):
    jv, variables, _, inputs = setup
    jcfg = jcore.AdilConfig(n_atoms=K, batch_size=BATCH, loss="ce", perturb_dtype=dtype)
    opt = jcore.make_optimizer(jcfg.step_size)
    d = jax.device_put(jnp.asarray(inputs["d"]), NamedSharding(mesh, P(None, None)))
    v = jax.device_put(jnp.asarray(inputs["v"]), NamedSharding(mesh, P("data", None)))
    images = jdp.shard_rows(mesh, jnp.asarray(inputs["images"]))
    labels = jdp.label_rows_sharded(jv.apply_fn, variables, images, mesh)
    plan = jax.device_put(jnp.asarray(inputs["plan"], jnp.int32),
                          NamedSharding(mesh, P("data", None, None)))
    return jcfg, (d, opt.init(d), v, opt.init(v), images, labels, plan, variables)


def test_replay_epoch_matches_jax(setup):
    jv, variables, pv, inputs = setup
    jcfg = jcore.AdilConfig(n_atoms=K, batch_size=BATCH, loss="ce")
    cfg = core.AdilConfig(n_atoms=K, batch_size=BATCH, loss="ce")
    plan = adil_dp.global_batches_from_local(inputs["plan"], N_LOCAL)
    images = np.concatenate([inputs["images"], np.zeros((1, SIZE, SIZE, 3), np.float32)])
    labels = np.asarray(jcore.predict_labels(jv.apply_fn, variables, jnp.asarray(images)))
    opt = jcore.make_optimizer(jcfg.step_size)
    d, v = jnp.asarray(inputs["d"]), jnp.asarray(inputs["v"])
    jd, _, jvv, _, jloss, jfool = jdp.make_dp_replay_epoch_fn(jv.apply_fn, jcfg)(
        d, opt.init(d), v, opt.init(v), jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(plan, jnp.int32), variables)
    state = core.TrainState(d=t(inputs["d"]), v=t(inputs["v"]),
                            d_mu=torch.zeros(K, SIZE * SIZE * 3), d_nu=torch.zeros(K, SIZE * SIZE * 3),
                            v_mu=torch.zeros(N_LOCAL * N_DEV, K), v_nu=torch.zeros(N_LOCAL * N_DEV, K))
    loss, fool = adil_dp.make_dp_replay_epoch_fn(pv, cfg)(
        state, t(images), torch.tensor(labels, dtype=torch.long), plan)
    np.testing.assert_allclose(state.d.numpy(), np.asarray(jd), atol=2e-3 * LR, rtol=0)
    np.testing.assert_allclose(state.v.numpy(), np.asarray(jvv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(fool) == float(jfool)
    assert state.d_count == state.v_count == plan.shape[0]


def test_dp_epoch_on_two_gloo_ranks_matches_jax(setup, ranks):
    mesh = jpar.data_mesh(N_DEV)
    jcfg, args = _jax_inputs(setup, mesh)
    jd, _, jvv, _, jloss, jfool = jdp.make_dp_epoch_fn(setup[0].apply_fn, jcfg, mesh)(*args)
    for out in ranks:
        np.testing.assert_allclose(out["float32_d"], np.asarray(jd), atol=2e-3 * LR, rtol=0)
        np.testing.assert_allclose(out["float32_v"], np.asarray(jvv), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["float32_sums"], [float(jloss), float(jfool)], rtol=1e-5)
        assert out["float32_counts"].tolist() == [2, 2]  # two steps, both halves
    # Each rank labelled its own rows, as the JAX shards do.
    labels = np.asarray(args[5])
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["float32_labels"], labels[r * N_LOCAL:(r + 1) * N_LOCAL])


def test_dp_epoch_matches_its_replay(setup, ranks):
    # The partition-matched serial replay of the same plan, in the port.
    _, _, pv, inputs = setup
    cfg = core.AdilConfig(n_atoms=K, batch_size=BATCH, loss="ce")
    images = t(np.concatenate([inputs["images"], np.zeros((1, SIZE, SIZE, 3), np.float32)]))
    state = core.TrainState(d=t(inputs["d"]), v=t(inputs["v"]),
                            d_mu=torch.zeros(K, SIZE * SIZE * 3), d_nu=torch.zeros(K, SIZE * SIZE * 3),
                            v_mu=torch.zeros(N_LOCAL * N_DEV, K), v_nu=torch.zeros(N_LOCAL * N_DEV, K))
    loss, fool = adil_dp.make_dp_replay_epoch_fn(pv, cfg)(
        state, images, core.predict_labels(pv, images),
        adil_dp.global_batches_from_local(inputs["plan"], N_LOCAL))
    np.testing.assert_allclose(ranks[0]["float32_d"], state.d.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ranks[0]["float32_v"], state.v.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ranks[0]["float32_sums"], [float(loss), float(fool)], rtol=1e-6)


def test_bf16_dp_epoch_matches_jax(setup, ranks):
    mesh = jpar.data_mesh(N_DEV)
    jcfg, args = _jax_inputs(setup, mesh, "bfloat16")
    epoch = jdp.make_dp_epoch_fn(setup[0].apply_fn, jcfg, mesh)
    jd, _, jvv, _, jloss, _ = epoch.lower(*args).compile(compiler_options=EXACT)(*args)
    tol = 2.0 ** -8 * LR * 2  # two steps
    for out in ranks:
        np.testing.assert_allclose(out["bfloat16_d"], np.asarray(jd), atol=tol, rtol=0)
        np.testing.assert_allclose(out["bfloat16_v"], np.asarray(jvv), atol=tol, rtol=0)
        np.testing.assert_allclose(out["bfloat16_sums"][0], float(jloss), rtol=2.0 ** -8)
        assert out["bfloat16_d"].dtype == np.float32
    assert float(np.abs(ranks[0]["bfloat16_d"] - ranks[0]["float32_d"]).max()) > 0


def test_both_ranks_hold_the_same_results(ranks):
    a, b = ranks
    for key in a:
        if key.endswith("_labels"):
            continue  # each rank's own rows
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_killed_and_resumed_run_equals_the_whole_one(ranks):
    for out in ranks:
        assert bool(out["ckpt_left_after_kill"]) and not bool(out["ckpt_left_at_end"])
        for part in ("d", "loss", "fooling", "val"):
            np.testing.assert_array_equal(out[f"resumed_{part}"], out[f"whole_{part}"])
        assert out["whole_loss"].shape == (3,)
        assert out["whole_d"].shape == (K, SIZE, SIZE, 3) and out["saved_v"].shape == (N_IMG, K)
        assert float(np.abs(out["whole_d"]).max()) <= 1.0
        assert float(np.abs(out["saved_v"]).sum(1).max()) <= 8 / 255 + 1e-6


def test_sharded_accuracy_equals_the_unsharded(setup, ranks):
    jv, variables, pv, inputs = setup
    data = (inputs["images"], inputs["acc_labels"])
    want = model_accuracy(data, pv)
    assert want == pytest.approx(4 / 7)
    assert jax_model_accuracy(data, jv) == want
    assert [float(out["accuracy"]) for out in ranks] == [want, want]


def test_check_mesh_and_the_mesh_size_at_two_ranks(ranks):
    for out in ranks:
        assert out["health"].tolist() == [1.0, 2.0, 3.0, 3.0]  # ok, 2 ranks, 1 + 2
        assert "requested 3 devices, have 2 ranks" in str(out["wrong_size_error"])


def _uap_plans():
    # The worker's UAPPGD(mesh=...) draws its epochs' plans from seed 0.
    plans = adil_dp.plan_generator(UAP_KW["seed"])
    return [adil_dp.make_local_batches(plans, N_IMG, N_DEV, BATCH) for _ in range(UAP_KW["steps"])]


def test_uap_pgd_dp_epochs_match_their_serial_replay(setup, ranks, tmp_path):
    # The replay: the same plans, each step's union batch split into the
    # ranks' parts, the whole set padded as shard_rows pads it.
    _, _, pv, inputs = setup
    atk = UAPPGD(pv, batch_size=BATCH, cache=ArtifactCache(str(tmp_path)), **{**UAP_KW, "steps": 0})
    pad = N_LOCAL * N_DEV - N_IMG
    images = t(np.concatenate([inputs["images"], np.zeros((pad, SIZE, SIZE, 3), np.float32)]))
    labels = torch.tensor(np.concatenate([inputs["acc_labels"], np.zeros(pad, np.int64)]))
    e = torch.zeros((1, SIZE, SIZE, 3), requires_grad=True)
    opt = atk.make_optimizer([e])
    epoch = uap_pgd.make_uap_dp_replay_epoch_fn(pv, atk, N_DEV)
    losses = [float(epoch(e, opt, images, labels,
                          torch.as_tensor(adil_dp.global_batches_from_local(plan, N_LOCAL)))[0])
              for plan in _uap_plans()]
    for out in ranks:
        assert float(np.abs(out["uap_e"] - e.detach().numpy()).max()) <= 1e-6
        np.testing.assert_allclose(out["uap_loss"], losses, rtol=1e-6)
        assert out["uap_saved"].tolist() == [True, False]  # only rank 0 writes
    assert float(np.linalg.norm(ranks[0]["uap_e"])) == pytest.approx(UAP_KW["eps"], rel=1e-5)


def test_uap_pgd_dp_epochs_on_two_gloo_ranks_match_jax(setup, ranks, tmp_path):
    # The JAX package's shard_map epoch on a two-device mesh, over the same
    # rows, true labels and local plans: e (l2) within 1e-5, the epochs'
    # losses within 1e-5 relative.
    jv, _, _, inputs = setup
    mesh = jpar.data_mesh(N_DEV)
    jatk = juap.UAPPGD(jv, batch_size=BATCH, cache=JaxArtifactCache(str(tmp_path)),
                       **{**UAP_KW, "steps": 0})
    epoch = juap.make_uap_epoch_fn(jv.apply_fn, jatk, mesh=mesh)
    images = jdp.shard_rows(mesh, jnp.asarray(inputs["images"]))
    labels = jdp.shard_rows(mesh, jnp.asarray(inputs["acc_labels"], jnp.int32))
    e = jax.device_put(jnp.zeros((1, SIZE, SIZE, 3)), NamedSharding(mesh, P(None, None, None, None)))
    opt_state, losses = jatk.make_optimizer().init(e), []
    for plan in _uap_plans():
        batches = jax.device_put(jnp.asarray(plan, jnp.int32), NamedSharding(mesh, P("data", None, None)))
        e, opt_state, loss, _ = epoch(e, opt_state, images, labels, batches)
        losses.append(float(loss))
    for out in ranks:
        assert float(np.abs(out["uap_e"] - np.asarray(e)).max()) <= 1e-5
        np.testing.assert_allclose(out["uap_loss"], losses, rtol=1e-5)


def test_demo_runs_distributed_and_mixed_at_world_size_one(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for key in _ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    args = demo.build_argparser().parse_args(
        ["--synthetic", "16", "--distributed", "--mixed-precision", "--device", "cpu",
         "--steps", "2", "--n-atoms", "4", "--steps-inference", "2"])
    try:
        results = demo.main(args)
        from dl_attack_on_imagenet_tpu_torch.parallel import check_mesh, data_mesh

        assert check_mesh(data_mesh())["ok"]
    finally:
        port_dist.shutdown()
    assert 0.0 <= results["accuracy"] <= 1.0
    assert os.listdir("dict_model_ImageNet_version_constrained") == ["results_tiny_seed42.msgpack"]
    assert "saved results to" in capsys.readouterr().out


def test_blocked_dp_learning_matches_its_replay(ranks):
    # The partition-matched serial replay on the blocked twin: the same D
    # and v draws in the blocked shape, the same plans, D put back in pixel
    # order at the end.
    b = BLOCKED
    victim, images = blocked_inputs()
    twin = blocked_twin(victim)
    n_local = -(-b["n"] // N_DEV)
    padded = np.concatenate([images, np.zeros((n_local * N_DEV - b["n"],) + images.shape[1:],
                                              np.float32)])
    xb = space_to_depth(t(padded))
    cfg = core.AdilConfig(n_atoms=b["k"], batch_size=b["batch"], loss="ce")
    state = core.init_state(torch.Generator().manual_seed(b["seed"]), tuple(xb.shape[1:]),
                            n_local * N_DEV, cfg, mode="distributed")
    plans = adil_dp.plan_generator(b["seed"])
    epoch = adil_dp.make_dp_replay_epoch_fn(twin, cfg)
    labels = core.predict_labels(twin, xb)
    losses = []
    for _ in range(b["steps"]):
        plan = adil_dp.make_local_batches(plans, b["n"], N_DEV, b["batch"])
        losses.append(float(epoch(state, xb, labels,
                                  adil_dp.global_batches_from_local(plan, n_local))[0]) / b["n"])
    d = depth_to_space(core.d_image(state.d, tuple(xb.shape[1:])))
    for out in ranks:
        assert bool(out["blocked_ran"])
        assert out["blocked_d"].shape == (b["k"], b["size"], b["size"], 3)
        np.testing.assert_allclose(out["blocked_d"], d.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["blocked_v"], state.v[:b["n"]].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["blocked_loss"], losses, rtol=1e-5)
