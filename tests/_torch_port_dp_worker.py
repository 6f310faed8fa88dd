"""One rank of the two-rank gloo runs of ``tests/test_torch_port_parallel.py``
and ``tests/test_torch_port_sharded_ckpt.py``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_torch_port_dp_worker.py DIR [sharded]

Reads the inputs from ``DIR/inputs.npz`` and the tiny victim's weights from
``DIR/tiny.pt``, runs every data-parallel piece of the port on the CPU
over gloo, and writes what it found to ``DIR/rank<r>.npz``: the mesh check,
one DP epoch in fp32 and in bf16 from the given state over the given plan,
the sharded accuracy, ``ADIL(mesh=...)`` run whole and killed after its
first checkpoint and resumed, two epochs of ``UAPPGD(mesh=...)``, and two
epochs of ``learn_dictionary_distributed`` in the space-to-depth layout on
a ResNet-18 with an S2D stem. With ``sharded`` it runs only the
checkpoints' kill-and-resume at two ranks (:func:`sharded_runs`). It imports neither JAX
nor the JAX package.
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
    and killed when its second checkpoint is due, then resumed. At two
    ranks ``ckpt_sharded="auto"`` takes the collective sharded checkpoint."""
    data = (inp["images"], np.zeros(len(inp["images"])))
    kw = dict(n_atoms=int(inp["k"]), steps=3, batch_size=int(inp["batch"]), loss="ce", mesh=mesh,
              checkpoint_every=1, data_val=(inp["images"][:3], np.zeros(3)), steps_inference=2)
    whole = ADIL(victim, cache=ArtifactCache(f"{root}/whole"), data_train=data, **kw)
    real_save, saves = adil_dp._ckpt_save_sharded, []

    def save_then_kill(*args):
        saves.append(1)
        if len(saves) == 2:
            raise Killed  # on every rank, so that none waits in a collective
        real_save(*args)

    cache = ArtifactCache(f"{root}/resumed")
    adil_dp._ckpt_save_sharded = save_then_kill
    try:
        ADIL(victim, cache=cache, data_train=data, **kw)
        raise AssertionError("the run was not killed")
    except Killed:
        pass
    finally:
        adil_dp._ckpt_save_sharded = real_save
    left = cache.exists_sharded("ImageNet", model="tiny", kind="dp_train_state_torch")
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
    out["ckpt_left_at_end"] = np.asarray(cache.exists_sharded("ImageNet", model="tiny",
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


# The sharded runs' checkpoint key; the test reads the directory under it.
SHARDED_KEY = {"model": "shrt", "kind": "dp_train_state"}


class _WatchedCache(ArtifactCache):
    """An ArtifactCache that notes when the sharded checkpoint is removed,
    which ``learn_dictionary_distributed`` does just before its return."""

    removed = False

    def remove_sharded(self, *args, **kwargs):
        super().remove_sharded(*args, **kwargs)
        self.removed = True


def _read_dir(path):
    """D, v and the epoch of a sharded checkpoint directory, read back in
    this process alone, and the row chunks of v in its metadata."""
    import torch.distributed.checkpoint as dcp

    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    tree = {"d": torch.empty(saved["d"].size), "v": torch.empty(saved["v"].size),
            "meta": {"epoch": torch.empty((), dtype=torch.int64)}}
    dcp.load(tree, checkpoint_id=path, no_dist=True)
    return {"sharded_dir_d": tree["d"].numpy(), "sharded_dir_v": tree["v"].numpy(),
            "sharded_dir_epoch": tree["meta"]["epoch"].numpy(),
            "sharded_dir_v_chunks": np.array([[c.offsets[0], c.sizes[0]]
                                              for c in saved["v"].chunks])}


def sharded_runs(victim, inp, mesh, root):
    """``learn_dictionary_distributed`` from the D and v of ``inp`` with a
    checkpoint each epoch: whole with ``ckpt_sharded="auto"`` (noting the
    checkpoint it took), and for each of ``ckpt_sharded=True`` and False,
    killed after its second checkpoint, then resumed. On the sharded runs
    ``_gather_rows`` raises until the checkpoint is removed at the end.
    Also the directory left by the sharded kill (its tensors, as read back
    in one process, and the row chunks of v in its metadata), each rank's D
    and rows of v when it was written, and each rank's D just after the
    restore."""
    rank = dist.get_rank()
    n_local = inp["v"].shape[0] // mesh.size()
    cfg = core.AdilConfig(n_atoms=int(inp["k"]), batch_size=int(inp["batch"]),
                          steps=int(inp["steps"]), loss="ce")
    data = ArrayDataset(inp["images"], np.zeros(len(inp["images"]), np.int64))
    real = {name: getattr(adil_dp, name) for name in
            ("init_dp_state", "_gather_rows", "_ckpt_save", "_ckpt_save_sharded",
             "_ckpt_restore_sharded")}
    out, caches, saves, took = {}, [], [], []

    def init_with_v(*args, **kwargs):
        state = real["init_dp_state"](*args, **kwargs)
        state.v.copy_(torch.as_tensor(inp["v"][rank * n_local:(rank + 1) * n_local]))
        return state

    def gather_at_the_end(*args):
        if caches[-1][1] and not caches[-1][0].removed:
            raise AssertionError("v was gathered before the end of the run")
        return real["_gather_rows"](*args)

    def save_then_kill(name):
        def save(cache, key, state, *args):
            real[name](cache, key, state, *args)
            took.append(name)
            saves.append(1)
            if len(saves) == 2:
                if name == "_ckpt_save_sharded":
                    out.update(sharded_kill_d=state.d.numpy().copy(),
                               sharded_kill_v=state.v.numpy().copy())
                raise Killed
        return save

    def note(name):
        def save(*args):
            took.append(name)
            return real[name](*args)
        return save

    def restore_and_note(cache, key, state, *args):
        restored = real["_ckpt_restore_sharded"](cache, key, state, *args)
        out["sharded_restored_d"] = state.d.numpy().copy()
        return restored

    def run(cache, flag):
        caches.append((cache, flag is not False))
        return adil_dp.learn_dictionary_distributed(
            victim, data, cfg, mesh, seed=0, d_init=inp["d"], checkpoint_every=1, cache=cache,
            ckpt_key=SHARDED_KEY, ckpt_sharded=flag)

    adil_dp.init_dp_state, adil_dp._gather_rows = init_with_v, gather_at_the_end
    try:
        for name in ("_ckpt_save", "_ckpt_save_sharded"):
            setattr(adil_dp, name, note(name))
        d, v, history = run(_WatchedCache(f"{root}/whole"), "auto")
        out.update(whole_d=d.numpy(), whole_v=v.numpy(), whole_loss=np.asarray(history["loss"]),
                   whole_fooling=np.asarray(history["fooling_rate"]),
                   auto_took=np.asarray(sorted(set(took))))
        adil_dp._ckpt_restore_sharded = restore_and_note
        for flag, name, tag in ((True, "_ckpt_save_sharded", "sharded"),
                                (False, "_ckpt_save", "msgpack")):
            cache = _WatchedCache(f"{root}/{tag}")
            saves.clear()
            setattr(adil_dp, name, save_then_kill(name))
            try:
                run(cache, flag)
                raise AssertionError("the run was not killed")
            except Killed:
                pass
            finally:
                setattr(adil_dp, name, real[name])
            if flag:
                if rank == 0:
                    out.update(_read_dir(cache._sharded_path("ImageNet", **SHARDED_KEY)))
                dist.barrier()
            d, v, history = run(cache, flag)
            out.update({f"{tag}_resumed_d": d.numpy(), f"{tag}_resumed_v": v.numpy(),
                        f"{tag}_resumed_loss": np.asarray(history["loss"]),
                        f"{tag}_resumed_fooling": np.asarray(history["fooling_rate"]),
                        f"{tag}_left": np.asarray(
                            cache.exists_sharded("ImageNet", **SHARDED_KEY)
                            or cache.exists("ImageNet", **SHARDED_KEY))})
    finally:
        for name, fn in real.items():
            setattr(adil_dp, name, fn)
    return out


def main(root: str, only: str = "") -> None:
    torch.set_num_threads(2)
    auto_initialize(device="cpu")
    rank = dist.get_rank()
    mesh = data_mesh()
    inp = dict(np.load(f"{root}/inputs.npz"))
    victim = create_model("tiny", device="cpu", state_dict=torch.load(f"{root}/tiny.pt"))
    if only == "sharded":
        np.savez(f"{root}/rank{rank}.npz", **sharded_runs(victim, inp, mesh, root))
        dist.destroy_process_group()
        return
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
    main(*sys.argv[1:])
