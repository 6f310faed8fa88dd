"""Data-parallel ADiL dictionary learning over a data mesh.

Port of ``dl_attack_on_imagenet_tpu/parallel/adil_dp.py``, over
``torch.distributed``, in the reference's own layout (its DDP path,
``adil.py:334-430``):

- images and the per-image codes ``v`` (with v's AdamW moments) shard by
  rows: rank p holds rows ``[p * n_local, (p + 1) * n_local)`` of the
  zero-padded set, and each rank runs its own shuffled plan of them;
- D and its moments replicate; D's gradient is all-reduced as a SUM each
  step (JAX's ``psum``, DDP's backward all-reduce), so the update every
  rank applies to D is the same;
- the loss and fooling sums are all-reduced, so every rank holds one
  history, and the convergence test reads the reduced loss: every rank
  leaves the loop at the same epoch. (The reference gates its loop on rank
  0, which leaves the other ranks waiting in a collective.)

The checkpoint is either the rank-0 one (v gathered, one payload) or the
collective DCP one (``ckpt_sharded``): D and its moments once, each
rank's rows of v and its moments from that rank.

``blocked`` trains in the space-to-depth layout of a victim with an S2D
stem, as the serial ``ADIL`` does: the all-reduce of D's gradient is
elementwise, so it commutes with the column permutation.

Collectives are ``all_reduce`` and ``broadcast`` on device tensors only, so
one code path runs over NCCL between cards and over gloo on the CPU or on
one card. Both halves of each step go through ``fused_adamw_project`` on a
CUDA tensor, as in the serial step (``adil_core.make_train_step``).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..attacks import adil_core as core
from ..attacks.adil_core import AdilConfig
from ..data import ArrayDataset
from ..models import blocked_twin, depth_to_space, space_to_depth
from ..utils import StepTimer
from .dist import current_device


def _group_rank(mesh: DeviceMesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_rank(group)


def make_dp_epoch_fn(model, cfg: AdilConfig, mesh: DeviceMesh, axis: str = "data"):
    """One data-parallel epoch over ``mesh``.

    ``epoch(state, images, labels, batches) -> (loss_sum, fooling_sum)``:

    - state: a :class:`adil_core.TrainState` with D flat ``(K, H*W*C)``
      and its moments replicated, and v and its moments this rank's rows
      ``(n_local, K)``; updated in place;
    - images ``(n_local, H, W, C)`` and clean labels ``(n_local,)``: this
      rank's rows (:func:`shard_rows`, :func:`label_rows_sharded`);
    - batches: the whole plan ``(n_dev, n_batches, B_local)`` of LOCAL row
      indices, -1 for padding (:func:`make_local_batches`); this rank runs
      its own row;
    - the sums are global (all-reduced) device scalars.
    """
    group, rank = _group_rank(mesh, axis)
    step = core.make_train_step(model, cfg, "both",
                                reduce_d_grad=lambda g: dist.all_reduce(g, group=group))

    def epoch(state: core.TrainState, images, labels, batches):
        plan = torch.as_tensor(np.asarray(batches)[rank], device=state.d.device)
        sums = torch.stack(core.run_epoch(step, state, *core.preslice_epoch(images, labels, plan)))
        dist.all_reduce(sums, group=group)
        return sums[0], sums[1]

    return epoch


def global_batches_from_local(batches: np.ndarray, n_local: int) -> np.ndarray:
    """Partition-matched GLOBAL plan from per-device LOCAL plans.

    ``batches`` is :func:`make_local_batches`' (n_dev, n_batches, B_local)
    output; step t's global batch is the union of every device's step-t
    local batch, with local row r on device p mapping to global row
    ``p * n_local + r`` (the :func:`shard_rows` layout) and -1 padding
    preserved. Feeding this plan to :func:`make_dp_replay_epoch_fn` replays
    the exact per-step batch composition the DP run saw.
    """
    batches = np.asarray(batches)
    n_dev, n_batches, b_local = batches.shape
    offsets = (np.arange(n_dev, dtype=batches.dtype) * n_local)[:, None, None]
    g = np.where(batches >= 0, batches + offsets, -1)
    return np.ascontiguousarray(
        g.transpose(1, 0, 2).reshape(n_batches, n_dev * b_local)
    )


def make_dp_replay_epoch_fn(model, cfg: AdilConfig):
    """One-process replay of :func:`make_dp_epoch_fn` on the union batches.

    ``epoch(state, images, labels, batches) -> (loss_sum, fooling_sum)``
    with the whole padded set, the whole v, and ``batches`` of shape
    (n_batches, B_global) (:func:`global_batches_from_local`). The union
    batch makes the serial D gradient the sum of the ranks' D gradients,
    each v row sees the same gradient, and rows outside a batch decay
    alike, so the DP run equals it up to the order of the sums.
    """
    step = core.make_train_step(model, cfg, "both")

    def epoch(state: core.TrainState, images, labels, batches):
        plan = torch.as_tensor(np.asarray(batches), device=state.d.device)
        return core.run_epoch(step, state, *core.preslice_epoch(images, labels, plan))

    return epoch


def make_local_batches(generator: torch.Generator, n_total: int, n_devices: int,
                       batch_size_global: int) -> np.ndarray:
    """Per-device shuffled local batch plans (n_dev, n_batches, B_local).

    Every device gets ``batch_size_global // n_devices`` rows a step from
    its ``ceil(n_total / n_devices)`` rows (DistributedSampler and a
    per-rank DataLoader); padded slots are -1 and masked out of the loss.
    The permutations come from ``generator`` in device order, so every rank
    that holds a generator in the same state draws the same whole plan.
    """
    b_local = max(batch_size_global // n_devices, 1)
    n_local = -(-n_total // n_devices)  # rows a shard, padding included
    n_batches = -(-n_local // b_local)
    plans = np.full((n_devices, n_batches * b_local), -1, np.int64)
    for p in range(n_devices):
        real = max(min(n_total - p * n_local, n_local), 0)
        perm = torch.randperm(real, generator=generator, device=generator.device)
        plans[p, :real] = perm.cpu().numpy()
    return plans.reshape(n_devices, n_batches, b_local)


def shard_rows(mesh: DeviceMesh, arr, axis: str = "data", device=None) -> torch.Tensor:
    """This rank's rows ``[rank * n_local, (rank + 1) * n_local)`` of an
    (N, ...) array zero-padded to ``n_local * n_dev`` rows, on ``device``
    (by default this rank's)."""
    group, rank = _group_rank(mesh, axis)
    arr = torch.as_tensor(arr)
    n_local = -(-arr.shape[0] // mesh.size())
    rows = arr[rank * n_local:(rank + 1) * n_local]
    pad = n_local - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad,) + tuple(rows.shape[1:]))])
    return rows.to(device or current_device()).contiguous()


def label_rows_sharded(model, images: torch.Tensor, mesh: DeviceMesh, axis: str = "data",
                       batch_size: int = 256) -> torch.Tensor:
    """Clean-model labels of this rank's rows (:func:`shard_rows`), computed
    on this rank: no rank reads another's images."""
    return core.predict_labels(model, images, batch_size)


def _gather_rows(local: torch.Tensor, n_dev: int, rank: int, group) -> torch.Tensor:
    """The whole ``(n_dev * n_local, ...)`` of a row-sharded tensor on
    every rank: zeros with this rank's rows in place, all-reduced (a sum
    with zeros, so exact)."""
    n_local = local.shape[0]
    whole = local.new_zeros((n_dev * n_local,) + tuple(local.shape[1:]))
    whole[rank * n_local:(rank + 1) * n_local] = local
    dist.all_reduce(whole, group=group)
    return whole


def _barrier(device, group) -> None:
    """Wait on the host until every rank of ``group`` gets here."""
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag, group=group)
    flag.item()


_ROWS = ("v", "v_mu", "v_nu")
_REPLICATED = ("d", "d_mu", "d_nu")


def _ckpt_save(cache, ckpt_key: dict, state: core.TrainState, generator: torch.Generator,
               loss_all, fooling_all, mesh: DeviceMesh, axis: str) -> None:
    """Persist the whole training state: v and its moments gathered by an
    all-reduce, written by rank 0 as one msgpack payload; then a barrier,
    so that no rank runs ahead of a checkpoint that is not on disk."""
    group, rank = _group_rank(mesh, axis)
    payload = {name: getattr(state, name) for name in _REPLICATED}
    payload.update({name: _gather_rows(getattr(state, name), mesh.size(), rank, group)
                    for name in _ROWS})
    payload.update(d_count=state.d_count, v_count=state.v_count, epoch=state.epoch,
                   rng=generator.get_state(), loss=np.asarray(loss_all, np.float64),
                   fooling=np.asarray(fooling_all, np.float64))
    if rank == 0:
        cache.save(payload, "ImageNet", **ckpt_key)
    _barrier(state.d.device, group)


def _ckpt_restore(cache, ckpt_key: dict, state: core.TrainState, generator: torch.Generator,
                  mesh: DeviceMesh, axis: str):
    """Load :func:`_ckpt_save`'s payload into ``state`` (this rank's rows of
    v and its moments) and ``generator``, in place; returns its (losses,
    fooling rates), or None without one."""
    payload = cache.load("ImageNet", **ckpt_key)
    if payload is None:
        return None
    _, rank = _group_rank(mesh, axis)
    n_local = state.v.shape[0]
    for name in _REPLICATED:
        dst = getattr(state, name)
        dst.copy_(torch.as_tensor(payload[name]).reshape(dst.shape))
    for name in _ROWS:
        getattr(state, name).copy_(torch.as_tensor(payload[name][rank * n_local:(rank + 1) * n_local]))
    state.d_count = int(payload["d_count"])
    state.v_count = int(payload["v_count"])
    state.epoch = int(payload["epoch"])
    generator.set_state(torch.as_tensor(payload["rng"], dtype=torch.uint8))
    return list(payload["loss"]), list(payload["fooling"])


def _meta(state: core.TrainState, generator: torch.Generator, loss_all, fooling_all,
          steps: int, world: int) -> dict:
    """The sharded checkpoint's host-side state: the counters, the plan
    generator's state, the world size, and the loss and fooling curves
    padded with zeros to ``steps`` entries so that the restore template's
    shapes are static (``epoch`` says how many are real; the JAX package's
    ``_meta_template``)."""
    def pad(values):
        out = torch.zeros(steps, dtype=torch.float64)
        out[:len(values)] = torch.tensor(values, dtype=torch.float64)
        return out

    return {"d_count": torch.tensor(state.d_count), "v_count": torch.tensor(state.v_count),
            "epoch": torch.tensor(state.epoch), "rng": generator.get_state(),
            "world": torch.tensor(world), "loss": pad(loss_all), "fooling": pad(fooling_all)}


def _sharded_tree(state: core.TrainState, meta: dict, mesh: DeviceMesh) -> dict:
    """D and its moments as plain tensors (DCP keeps one copy), v and its
    moments as ``DTensor``s of this rank's rows over ``mesh`` (each rank
    writes and reads its own), the meta beside them. The ``DTensor``s share
    the rows' storage: a restore lands in ``state``."""
    tree = {name: getattr(state, name) for name in _REPLICATED}
    tree.update({name: DTensor.from_local(getattr(state, name), mesh, [Shard(0)],
                                          run_check=False) for name in _ROWS})
    tree["meta"] = meta
    return tree


def _ckpt_save_sharded(cache, ckpt_key: dict, state: core.TrainState,
                       generator: torch.Generator, loss_all, fooling_all, mesh: DeviceMesh,
                       steps: int) -> None:
    """Persist the whole training state in a collective DCP save
    (``ArtifactCache.save_sharded``): no rank gathers v, so the save scales
    to codes that fit no single host."""
    meta = _meta(state, generator, loss_all, fooling_all, steps, mesh.size())
    cache.save_sharded(_sharded_tree(state, meta, mesh), "ImageNet", **ckpt_key)


def _ckpt_restore_sharded(cache, ckpt_key: dict, state: core.TrainState,
                          generator: torch.Generator, mesh: DeviceMesh, steps: int):
    """Collective restore of :func:`_ckpt_save_sharded`'s checkpoint into
    ``state`` (this rank's rows) and ``generator``, in place; returns its
    (losses, fooling rates), or None without one."""
    if not cache.exists_sharded("ImageNet", **ckpt_key):
        return None
    meta = _meta(state, generator, [], [], steps, mesh.size())
    cache.load_sharded(_sharded_tree(state, meta, mesh), "ImageNet", **ckpt_key)
    if int(meta["world"]) != mesh.size():
        raise ValueError(f"the sharded checkpoint was written by {int(meta['world'])} ranks, "
                         f"not {mesh.size()}: it resumes only at the world size that wrote it")
    state.d_count = int(meta["d_count"])
    state.v_count = int(meta["v_count"])
    state.epoch = int(meta["epoch"])
    generator.set_state(meta["rng"])
    return meta["loss"][:state.epoch].tolist(), meta["fooling"][:state.epoch].tolist()


def init_dp_state(device, image_shape, n_total: int, cfg: AdilConfig, mesh: DeviceMesh,
                  seed: int = 0, d_init=None, axis: str = "data") -> core.TrainState:
    """The state :func:`learn_dictionary_distributed` starts from: D (or
    ``d_init``) and the projected Gaussian codes of all ``n_pad`` rows drawn
    by rank 0 from a ``device`` generator seeded with ``seed``, broadcast,
    then this rank's rows of v kept."""
    group, rank = _group_rank(mesh, axis)
    n_local = -(-n_total // mesh.size())
    state = core.init_state(torch.Generator(device=device).manual_seed(seed), image_shape,
                            n_local * mesh.size(), cfg, mode="distributed", d_init=d_init)
    src = dist.get_global_rank(group, 0)
    for t in (state.d, state.v):
        dist.broadcast(t, src=src, group=group)
    rows = slice(rank * n_local, (rank + 1) * n_local)
    state.v = state.v[rows].clone()
    state.v_mu, state.v_nu = torch.zeros_like(state.v), torch.zeros_like(state.v)
    return state


def plan_generator(seed: int = 0) -> torch.Generator:
    """The host generator of the epochs' plans (:func:`make_local_batches`)."""
    return torch.Generator().manual_seed(seed)


def learn_dictionary_distributed(
    victim,
    dataset,
    cfg: AdilConfig,
    mesh: DeviceMesh,
    seed: int = 0,
    verbose: bool = False,
    axis: str = "data",
    data_val=None,
    val_every: int = 0,
    d_init=None,
    checkpoint_every: int = 0,
    cache=None,
    ckpt_key: Optional[dict] = None,
    resume: bool = True,
    blocked="auto",
    ckpt_sharded="auto",
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Data-parallel dictionary learning. Returns (D in its (K, H, W, C)
    presentation shape, v of the real rows, history), the same on every
    rank.

    Every rank calls it with the same arguments. ``d_init`` warm-starts D.
    With ``data_val`` and ``val_every``, each rank validates every
    ``val_every``-th epoch on its share of the val batches and the counts
    are all-reduced, so the number is the same everywhere. With
    ``checkpoint_every`` > 0 and a ``cache`` the whole state is saved every
    that many epochs (:func:`_ckpt_save`) and, with ``resume``, restored by
    every rank on the next call, so that a killed run resumes the
    uninterrupted trajectory.

    ``blocked`` ("auto" or True; False for none) trains in the layout of the
    victim's blocked twin (``models.blocked_twin``) where it has one and the
    images an even size, as the JAX package does: the images and the val
    set space-to-depth'd, D drawn in the blocked shape (a ``d_init`` is
    space-to-depth'd), the checkpoint under its own kind (``_s2d``
    appended), and D put back in pixel order at the end. The history has
    the per-epoch ``loss`` and ``fooling_rate``, the last ``val_fooling``,
    ``blocked`` (whether it ran blocked) and the epochs' ``timing``.

    ``ckpt_sharded`` chooses the checkpoint, as in the JAX package. False
    is the rank-0 checkpoint above: v and its
    moments all-reduced onto every rank, one payload written by rank 0
    through ``cache.save``. True is the collective DCP checkpoint
    (:func:`_ckpt_save_sharded`, the counterpart of the JAX package's orbax
    one): every rank writes its own rows of v and its moments under
    ``.dcp_sharded`` and restores them into its live rows, and nothing is
    gathered before the final return. "auto" (the default) takes the
    sharded one where there is more than one process (the mesh's size), as
    the JAX package's does where ``jax.process_count() > 1``; one process
    runs a card here, so any data-parallel run of more than one card keeps
    its codes where they are. The sharded kind
    resumes only at the world size that wrote it, as in the JAX package,
    whose templates fix the shapes: the padded row count ``n_local *
    world`` is part of its shapes, and a checkpoint of another world size
    raises instead of being resharded.
    """
    images_np, _ = dataset.as_arrays()
    n = images_np.shape[0]
    image_shape = tuple(dataset.image_shape)
    device = victim.device
    group, rank = _group_rank(mesh, axis)
    n_dev = mesh.size()

    twin = None
    if blocked and image_shape[0] % 2 == 0 and image_shape[1] % 2 == 0:
        twin = blocked_twin(victim)
    if twin is not None:
        images_np = space_to_depth(torch.as_tensor(np.asarray(images_np, np.float32))).numpy()
        image_shape = tuple(images_np.shape[1:])
        if d_init is not None:
            d_init = space_to_depth(torch.as_tensor(np.asarray(d_init, np.float32)))
        if data_val is not None:
            data_val = ArrayDataset(
                space_to_depth(torch.as_tensor(np.asarray(data_val.images, np.float32))).numpy(),
                data_val.labels)
        if ckpt_key:
            ckpt_key = {**ckpt_key, "kind": ckpt_key.get("kind", "dp_train_state_torch") + "_s2d"}
        victim = twin

    state = init_dp_state(device, image_shape, n, cfg, mesh, seed, d_init, axis)
    images = shard_rows(mesh, np.asarray(images_np, np.float32), axis, device)
    labels = label_rows_sharded(victim, images, mesh, axis)
    generator = plan_generator(seed)
    epoch_fn = make_dp_epoch_fn(victim, cfg, mesh, axis)

    ckpt_key = ckpt_key or {"model": getattr(victim, "name", "model"), "kind":
                            "dp_train_state_torch_s2d" if twin is not None
                            else "dp_train_state_torch"}
    loss_all, fooling_all, val_fool = [], [], None
    sharded = bool(checkpoint_every and cache is not None and (
        mesh.size() > 1 if ckpt_sharded == "auto" else ckpt_sharded))
    if checkpoint_every and cache is not None and resume:
        if sharded:
            restored = _ckpt_restore_sharded(cache, ckpt_key, state, generator, mesh, cfg.steps)
        else:
            restored = _ckpt_restore(cache, ckpt_key, state, generator, mesh, axis)
        if restored is not None:
            loss_all, fooling_all = restored
            if verbose and rank == 0:
                print(f"[adil dp] resumed at epoch {state.epoch}")

    timer = StepTimer(warmup=1)
    for it in range(state.epoch, cfg.steps):
        t0 = time.perf_counter()
        batches = make_local_batches(generator, n, n_dev, cfg.batch_size)
        sums = torch.stack(epoch_fn(state, images, labels, batches)).tolist()
        timer.record(time.perf_counter() - t0)
        loss_all.append(sums[0] / n)
        fooling_all.append(sums[1] / n)
        if data_val is not None and val_every and (it + 1) % val_every == 0:
            from ..attacks.adil import val_fooled

            fooled = val_fooled(victim, state.d, data_val, cfg, device, rank, n_dev)
            dist.all_reduce(fooled, group=group)
            val_fool = float(fooled) / len(data_val)
        if verbose and rank == 0:
            print(f"[adil dp] epoch {it} loss {loss_all[-1]:.4f} "
                  f"fooling {fooling_all[-1]:.3f} val {val_fool}")
        if checkpoint_every and cache is not None and (it + 1) % checkpoint_every == 0:
            if sharded:
                _ckpt_save_sharded(cache, ckpt_key, state, generator, loss_all, fooling_all,
                                   mesh, cfg.steps)
            else:
                _ckpt_save(cache, ckpt_key, state, generator, loss_all, fooling_all, mesh, axis)
        if it > 1 and abs(loss_all[-1] - loss_all[-2]) < cfg.tol:
            break

    if sharded:
        cache.remove_sharded("ImageNet", **ckpt_key)
    elif checkpoint_every and cache is not None and rank == 0:
        cache.remove("ImageNet", **ckpt_key)
    v = _gather_rows(state.v, n_dev, rank, group)[:n]
    history = {"loss": loss_all, "fooling_rate": fooling_all, "val_fooling": val_fool,
               "blocked": twin is not None, "timing": timer.summary()}
    d = core.d_image(state.d, image_shape)
    return (depth_to_space(d) if twin is not None else d), v, history
