"""One rank of the two-rank gloo run of ``tests/test_torch_port_parallel.py``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_torch_port_dp_worker.py DIR

Reads the inputs from ``DIR/inputs.npz`` and the tiny victim's weights from
``DIR/tiny.pt``, runs every data-parallel piece of the port on the CPU
over gloo, and writes what it found to ``DIR/rank<r>.npz``: the mesh check,
one DP epoch in fp32 and in bf16 from the given state over the given plan,
the sharded accuracy, ``ADIL(mesh=...)`` run whole and killed after its
first checkpoint and resumed, two epochs of ``UAPPGD(mesh=...)``, and two
epochs of ``learn_dictionary_distributed`` in the space-to-depth layout on
a ResNet-18 with an S2D stem. It imports neither JAX nor the JAX package.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from dl_attack_on_imagenet_tpu_torch.attacks import ADIL, UAPPGD
from dl_attack_on_imagenet_tpu_torch.attacks import adil_core as core
from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset
from dl_attack_on_imagenet_tpu_torch.evaluation import model_accuracy_sharded
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.parallel import adil_dp, auto_initialize, check_mesh, data_mesh
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache


class Killed(Exception):
    pass


def dp_epoch(victim, inp, mesh, dtype):
    """One DP epoch from the state in ``inp`` over its plan; returns D, the
    whole v (gathered), the global sums and this rank's labels."""
    rank, n_dev = dist.get_rank(), mesh.size()
    cfg = core.AdilConfig(n_atoms=int(inp["k"]), batch_size=int(inp["batch"]), loss="ce",
                          perturb_dtype=dtype)
    v_all = torch.tensor(inp["v"])
    n_local = v_all.shape[0] // n_dev
    v = v_all[rank * n_local:(rank + 1) * n_local].clone()
    d = torch.tensor(inp["d"])
    state = core.TrainState(d=d, v=v, d_mu=torch.zeros_like(d), d_nu=torch.zeros_like(d),
                            v_mu=torch.zeros_like(v), v_nu=torch.zeros_like(v))
    images = adil_dp.shard_rows(mesh, inp["images"])
    labels = adil_dp.label_rows_sharded(victim, images, mesh)
    loss, fooling = adil_dp.make_dp_epoch_fn(victim, cfg, mesh)(state, images, labels, inp["plan"])
    v_whole = adil_dp._gather_rows(state.v, n_dev, rank, mesh.get_group("data"))
    return {"d": state.d.numpy(), "v": v_whole.numpy(), "sums": np.array([float(loss), float(fooling)]),
            "labels": labels.numpy(), "counts": np.array([state.d_count, state.v_count])}


def adil_runs(victim, inp, mesh, root):
    """ADIL(mesh=...) over three epochs with a checkpoint after each: whole,
    and killed when its second checkpoint is due, then resumed."""
    data = (inp["images"], np.zeros(len(inp["images"])))
    kw = dict(n_atoms=int(inp["k"]), steps=3, batch_size=int(inp["batch"]), loss="ce", mesh=mesh,
              checkpoint_every=1, data_val=(inp["images"][:3], np.zeros(3)), steps_inference=2)
    whole = ADIL(victim, cache=ArtifactCache(f"{root}/whole"), data_train=data, **kw)
    real_save, saves = adil_dp._ckpt_save, []

    def save_then_kill(*args):
        saves.append(1)
        if len(saves) == 2:
            raise Killed  # on every rank, so that none waits in a collective
        real_save(*args)

    cache = ArtifactCache(f"{root}/resumed")
    adil_dp._ckpt_save = save_then_kill
    try:
        ADIL(victim, cache=cache, data_train=data, **kw)
        raise AssertionError("the run was not killed")
    except Killed:
        pass
    finally:
        adil_dp._ckpt_save = real_save
    left = cache.exists("ImageNet", model="tiny", kind="dp_train_state_torch")
    resumed = ADIL(victim, cache=cache, data_train=data, **kw)
    out = {}
    for name, attack in (("whole", whole), ("resumed", resumed)):
        out[f"{name}_d"] = attack.dictionary.numpy()
        out[f"{name}_loss"] = np.asarray(attack.history["loss"])
        out[f"{name}_fooling"] = np.asarray(attack.history["fooling_rate"])
        out[f"{name}_val"] = np.asarray(attack.history["val_fooling"])
    saved = ArtifactCache(f"{root}/whole").load("ImageNet", model="tiny")
    out["saved_v"] = saved["v"]
    out["ckpt_left_after_kill"] = np.asarray(left)
    out["ckpt_left_at_end"] = np.asarray(cache.exists("ImageNet", model="tiny",
                                                      kind="dp_train_state_torch"))
    return out


# The UAP-PGD run's settings; the test replays them.
UAP_KW = dict(steps=2, norm="l2", eps=0.5, seed=0)


def uap_run(victim, inp, mesh, root):
    """Two data-parallel UAP-PGD epochs on the images and ``acc_labels``,
    each rank with a cache of its own; then which ranks wrote an artifact."""
    rank, n_dev = dist.get_rank(), mesh.size()
    attack = UAPPGD(victim, data_train=(inp["images"], inp["acc_labels"]), mesh=mesh,
                    batch_size=int(inp["batch"]), cache=ArtifactCache(f"{root}/uap{rank}"),
                    **UAP_KW)
    dist.barrier()
    saved = [ArtifactCache(f"{root}/uap{r}").exists("UAPPGD", model="tiny") for r in range(n_dev)]
    return {"uap_e": attack.attack_vec.numpy(), "uap_loss": np.asarray(attack.history["loss"]),
            "uap_saved": np.asarray(saved)}


# The blocked run's settings; the test replays them.
BLOCKED = dict(size=16, n=7, k=4, batch=4, steps=2, seed=0)


def blocked_inputs():
    """(victim, images) of the blocked run: a seeded ResNet-18 with an S2D
    stem and seeded images."""
    b = BLOCKED
    victim = create_model("resnet18", input_size=b["size"], device="cpu", seed=3, stem_s2d=True)
    images = np.random.RandomState(6).uniform(0.0, 1.0, (b["n"], b["size"], b["size"], 3))
    return victim, images.astype(np.float32)


def blocked_run(mesh):
    """``learn_dictionary_distributed`` with ``blocked`` at its default."""
    b = BLOCKED
    victim, images = blocked_inputs()
    cfg = core.AdilConfig(n_atoms=b["k"], batch_size=b["batch"], steps=b["steps"], loss="ce")
    d, v, history = adil_dp.learn_dictionary_distributed(
        victim, ArrayDataset(images, np.zeros(b["n"], np.int64)), cfg, mesh, seed=b["seed"])
    return {"blocked_d": d.numpy(), "blocked_v": v.numpy(),
            "blocked_loss": np.asarray(history["loss"]), "blocked_ran": np.asarray(history["blocked"])}


def main(root: str) -> None:
    torch.set_num_threads(2)
    auto_initialize(device="cpu")
    rank = dist.get_rank()
    mesh = data_mesh()
    inp = dict(np.load(f"{root}/inputs.npz"))
    victim = create_model("tiny", device="cpu", state_dict=torch.load(f"{root}/tiny.pt"))
    out = {}
    health = check_mesh(mesh)
    out["health"] = np.array([health["ok"], health["n_devices"], health["psum"],
                              health["expected"]], np.float64)
    try:
        data_mesh(3)
        out["wrong_size_error"] = np.asarray("")
    except ValueError as e:
        out["wrong_size_error"] = np.asarray(str(e))
    for dtype in ("float32", "bfloat16"):
        out.update({f"{dtype}_{k}": v for k, v in dp_epoch(victim, inp, mesh, dtype).items()})
    out["accuracy"] = np.asarray(model_accuracy_sharded(
        (inp["images"], inp["acc_labels"]), victim, mesh, batch_size=3))
    if rank == 0:
        os.makedirs(f"{root}/adil", exist_ok=True)
    dist.barrier()
    out.update(adil_runs(victim, inp, mesh, f"{root}/adil"))
    out.update(uap_run(victim, inp, mesh, root))
    out.update(blocked_run(mesh))
    np.savez(f"{root}/rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
