"""ADIL — Adversarial Dictionary Learning attack.

Port of ``dl_attack_on_imagenet_tpu/attacks/adil.py``: the constructor, the
memoized dictionary artifact, dictionary learning (``method="gd"``, the
joint projected AdamW, with the dataset resident on the device, streamed
from the host, or decoded from a folder of JPEGs by the native loader, and
``method="alter"``, alternating v and D phases), data-parallel learning
over a ``parallel.data_mesh`` (``mesh=``), the step-level train-state
checkpoint, ``forward`` (supervised DDrague or unsupervised best-of-trials
sampling, learning first where no dictionary exists) and
``forward_supervised_adamw``, each in fp32 or in the bf16 mixed precision
of ``perturb_dtype="bfloat16"`` (``adil_core``).

``blocked`` ("auto", True or False): where the victim has a space-to-depth
stem (``models.blocked_twin``) and the images have an even size, the
resident ``gd`` path trains in the stem's layout (images space-to-depth'd,
D's columns permuted to match) and the supervised solvers serve through the
twin on a cached blocked copy of D. Every step, clamp, projection, Gram
matrix and squared norm is elementwise in D's columns or invariant under
their permutation, so the trajectory is the standard one under a fixed
column permutation. Artifacts always hold the presentation ``(K, H, W, C)``
dictionary; ``trained_blocked`` says whether the last run trained blocked.
The streamed, folder and ``alter`` paths train unblocked.

``pipeline_epochs`` ("auto", True or False): the resident ``gd`` loop
enqueues epoch t+1 before the host reads epoch t's sums (the epoch's one
sync), on a device snapshot of epoch t's state, so that the convergence
stop, the validation and the checkpoint of epoch t see exactly the serial
state. "auto" takes it where 3x the images and 3x the state fit in 60% of
the device's memory.

Spans (``utils.profiling``; ``adil_core`` has those of the step and the
solvers): ``adil/forward`` a ``forward`` call, its unit of work; a
resident job's start ``adil/prepare/copy``, ``adil/prepare/draws`` and
``adil/prepare/labels``; each epoch ``adil/epoch`` (its unit of work, with
the job), holding ``adil/epoch/draw`` (its batches and gather) and its
steps; ``adil/epoch_end`` its bookkeeping; the streamed and folder paths'
wait for their next batch ``adil/input_wait``. Each blocking host read
of device data is a ``sync/<site>`` span: ``sync/read_later`` (the
pipelined epoch's sums), ``sync/epoch_sums``, ``sync/labels``,
``sync/val_fooled``, ``sync/checkpoint``, ``sync/save``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import as_array_dataset, prefetch_to_device
from ..models import VictimModel, blocked_twin, depth_to_space, space_to_depth
from ..utils import ArtifactCache, MetricLogger, StepTimer, annotate
from . import adil_core as core
from .adil_core import AdilConfig
from .base import Attack


def _device_memory_budget(device: torch.device) -> int:
    """Bytes of memory on ``device``, for ``pipeline_epochs="auto"``: the
    card's total, and the JAX package's 64 GiB stand-in on the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return 64 << 30


def _copy_state(state: core.TrainState) -> core.TrainState:
    """A device copy of ``state`` (the pipelined loop's snapshot)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _copy_generator(generator: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


def _read_later(sums):
    """Start the copy of an epoch's (loss, fooling) sums to the host now,
    and return a function that waits for it and gives them as floats: on
    the card it waits for that epoch only, not for the work enqueued
    after it."""
    s = torch.stack(sums)
    if not s.is_cuda:
        host, done = s, None
    else:
        host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
        host.copy_(s, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def read():
        with annotate("sync/read_later"):
            if done is not None:
                done.synchronize()
            return host.tolist()

    return read


def _spanned(batches, name: str):
    """``batches``, the wait for each next one a span ``name``."""
    it = iter(batches)
    while True:
        with annotate(name):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def val_fooled(victim, d: torch.Tensor, data_val, cfg: AdilConfig, device,
               rank: int = 0, world: int = 1) -> torch.Tensor:
    """Validation: optimize fresh codes on the val set with D frozen and
    count how many fool the victim, as a device scalar (divide by the set's
    size for the rate).

    A ragged last batch is padded by cycling its rows, as the JAX package
    does to keep one compiled shape, and its count is scaled by its real
    share of the padded batch. ``rank`` of ``world`` takes every
    ``world``-th batch from its own; the ranks' counts sum to the whole.
    """
    ds = as_array_dataset(data_val)
    d = core.d_image(d, ds.image_shape)
    b = cfg.batch_size
    total = torch.zeros((), device=device)
    for i, (_, x, _) in enumerate(ds.batches(b)):
        if i % world != rank:
            continue
        k = x.shape[0]
        if k < b:
            x = np.concatenate([np.asarray(x)] * -(-b // k))[:b]
        images = torch.as_tensor(x, dtype=torch.float32, device=device)
        fooled = core.supervised_adamw_codes(victim, d, images, cfg, return_fooling=True)
        total += fooled * (k / b if k < b else 1.0)
    return total


class ADIL(Attack):
    """Adversarial Dictionary Learning (ADiL).

    Learns K perturbation atoms D shared across images plus per-image codes
    v so that ``x_i + D v_i`` fools a frozen classifier under an eps-ball
    budget; unseen images are attacked by optimizing fresh codes
    (``attack="supervised"``, DDrague) or by sampling them
    (``"unsupervised"``).
    """

    # Keep the whole dataset on the device unless it exceeds this many
    # bytes; larger datasets stream from the host (the JAX package's rule).
    RESIDENT_BYTES_LIMIT = 4 << 30

    def __init__(
        self,
        victim: VictimModel,
        eps: float = 8 / 255,
        steps: int = 500,
        norm: str = "linf",
        targeted: bool = False,
        n_atoms: int = 100,
        batch_size: int = 100,
        data_train=None,
        data_val=None,
        trials: int = 10,
        attack: str = "supervised",
        model_name: Optional[str] = None,
        step_size: float = 0.01,
        steps_in: int = 1,
        loss: str = "ce",
        method: str = "gd",
        warm_start: bool = False,
        kappa: float = 50.0,
        steps_inference: int = 30,
        mesh=None,
        cache: Optional[ArtifactCache] = None,
        seed: int = 0,
        val_every: Optional[int] = 1,
        verbose: bool = False,
        stream: Optional[bool] = None,
        checkpoint_every: Optional[int] = None,
        resume: bool = True,
        metrics_log: Optional[str] = None,
        blocked: Any = "auto",
        perturb_dtype: str = "float32",
        pipeline_epochs: Any = "auto",
    ):
        super().__init__(victim, "ADIL", targeted)
        if method not in ("gd", "alter"):
            raise ValueError(f"method must be 'gd' or 'alter', got {method!r}")
        self.cfg = AdilConfig(
            eps=eps,
            norm=norm.lower(),
            n_atoms=n_atoms,
            loss=loss,
            kappa=kappa,
            targeted=targeted,
            step_size=step_size,
            steps=int(steps),
            steps_inner=steps_in or 1,
            batch_size=batch_size,
            trials=int(trials),
            steps_inference=int(steps_inference),
            perturb_dtype=perturb_dtype,
        )
        self.attack_mode = attack
        self.method = method
        self.mesh = mesh
        self.warm_start = warm_start
        self.model_name = model_name or victim.name
        self.cache = cache or ArtifactCache("trained_dicts")
        self.seed = seed
        self.val_every = val_every
        self.verbose = verbose
        self.stream = stream
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.blocked = blocked
        self.pipeline_epochs = pipeline_epochs
        self.trained_blocked = False  # whether the last training run was blocked
        self._train_blocked = False  # whether the run in progress is
        self._blocked_d_cache = None
        self.metrics = MetricLogger(metrics_log)
        self.dictionary: Optional[torch.Tensor] = None
        self.history: dict = {}
        self.timing: dict = {}
        self._rng_calls = 0  # per-call seed offset so equal batches differ
        self._calls = 0  # forward calls, and learning jobs: the spans' units of work
        self._jobs = 0

        # Artifact memoization: train only if the trained-dictionary file is
        # missing.
        if data_train is not None and not self.cache.exists("ImageNet", model=self.model_name):
            self.learn_dictionary(data_train, data_val)

    # -- training ---------------------------------------------------------

    @property
    def is_trained(self) -> bool:
        """Whether ``forward`` would skip its lazy learn."""
        return self.dictionary is not None or self.cache.exists(
            "ImageNet", model=self.model_name)

    @property
    def device(self) -> torch.device:
        return self.victim.device

    def learn_dictionary(self, data_train, data_val=None) -> None:
        """Learn D (and the training codes v), save the artifact, and keep D
        as this attack's dictionary."""
        self._jobs += 1
        if self._is_path_dataset(data_train):
            data_train, data_val = self._dispatch_folder(data_train, data_val)
            if data_train is None:
                return  # trained from the JPEG files
        if self.mesh is not None:
            self._learn_distributed(data_train, data_val)
        elif self.method == "alter":
            self._learn_alter(data_train, data_val)
        elif self._should_stream(data_train):
            self._learn_gd_streamed(data_train, data_val)
        else:
            self._learn_gd(data_train, data_val)

    def _should_stream(self, data_train) -> bool:
        if self.stream is not None:
            return self.stream
        return as_array_dataset(data_train).images.nbytes > self.RESIDENT_BYTES_LIMIT

    @staticmethod
    def _is_path_dataset(data) -> bool:
        """Folder-of-JPEGs datasets (``ImageNetFolder``-like: ``samples`` of
        (path, label), no ``images``)."""
        return hasattr(data, "samples") and not hasattr(data, "images")

    def _dispatch_folder(self, folder, data_val):
        """Train ``gd`` straight from the files where the native loader
        builds, ``stream`` is not False and there is no mesh; otherwise
        decode the folder into arrays (with PIL where the loader is missing)
        and go on with those.
        Returns the (data_train, data_val) to go on with, or (None, None)
        once training is done."""
        from ..runtime import get_runtime

        runtime = get_runtime()
        if data_val is not None and self._is_path_dataset(data_val):
            data_val = data_val.materialize(runtime=runtime)
        if (runtime is not None and self.method != "alter" and self.stream is not False
                and self.mesh is None):
            self._learn_gd_from_folder(folder, data_val, runtime)
            return None, None
        return folder.materialize(runtime=runtime), data_val

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _load_warm_start(self) -> Optional[np.ndarray]:
        """The memoized dictionary as the initial D, if ``warm_start``."""
        if not self.warm_start:
            return None
        prev = self.cache.load("ImageNet", model=self.model_name)
        return prev["d"] if prev is not None else None

    def _init(self, image_shape, n: int, generator, mode: str) -> core.TrainState:
        return core.init_state(generator, image_shape, n, self.cfg, mode=mode,
                               d_init=self._load_warm_start())

    def _blocked_victim(self, image_shape) -> Optional[VictimModel]:
        """The victim's blocked twin where ``blocked`` allows it, the victim
        has an S2D stem and the images an even size; else None."""
        if not self.blocked or image_shape[0] % 2 or image_shape[1] % 2:
            return None
        return blocked_twin(self.victim)

    def _set_blocked(self, on: bool) -> None:
        self._train_blocked = self.trained_blocked = on

    def _prepare(self, data_train, mode: str, twin: Optional[VictimModel] = None):
        """Dataset, its images and clean labels on the device, generator and
        fresh state for a resident training run. With a blocked ``twin`` the
        images and D are space-to-depth'd and the labels are the twin's. In
        bf16 mode a ``gd`` run holds the images in bf16, after its labels
        are taken from fp32: the step casts x to bf16 anyway, and the
        epoch's gather moves half the bytes."""
        ds = as_array_dataset(data_train)
        unit = ("job", self._jobs, "prepare")
        with annotate("adil/prepare/copy", unit):
            images = torch.as_tensor(ds.images, dtype=torch.float32,
                                     device=self.device).contiguous()
        with annotate("adil/prepare/draws", unit):
            generator = self._generator()
            state = self._init(ds.image_shape, len(ds), generator, mode)
            if twin is not None:
                images = space_to_depth(images)
                state.d = space_to_depth(core.d_image(state.d, ds.image_shape)).reshape(
                    state.d.shape)
        with annotate("adil/prepare/labels", unit):
            labels = core.predict_labels(twin or self.victim, images)
        if mode == "gd" and self.cfg.compute_dtype is not None:
            images = images.to(self.cfg.compute_dtype)
        return ds, images, labels, generator, state

    def _val_fooling(self, d: torch.Tensor, data_val) -> float:
        """The share of the val set that fresh codes on the training D fool
        (:func:`val_fooled`, on the presentation dictionary)."""
        ds = as_array_dataset(data_val)
        d = self._present_d(d, ds.image_shape)
        fooled = val_fooled(self.victim, d, ds, self.cfg, self.device)
        with annotate("sync/val_fooled"):
            return float(fooled) / len(ds)

    def _present_d(self, d_flat: torch.Tensor, image_shape) -> torch.Tensor:
        """The training D in its presentation shape (K, H, W, C), its
        columns put back in pixel order where this run trains blocked."""
        if self._train_blocked:
            h, w, c = image_shape
            return depth_to_space(core.d_image(d_flat, (h // 2, w // 2, 4 * c)))
        return core.d_image(d_flat, image_shape)

    def _resolve_pipeline(self, images: torch.Tensor, state: core.TrainState) -> bool:
        """``pipeline_epochs``, with "auto" resolved against the device's
        memory: the pipelined loop holds a second presliced epoch and a
        snapshot of the state."""
        if self.pipeline_epochs != "auto":
            return bool(self.pipeline_epochs)
        img_bytes = images.numel() * images.element_size()
        state_bytes = sum(t.numel() * t.element_size()
                          for t in vars(state).values() if isinstance(t, torch.Tensor))
        return 3 * img_bytes + 3 * state_bytes < 0.6 * _device_memory_budget(images.device)

    def _end_epoch(self, t: int, tag: str, state, generator, sums, n: int,
                   history: dict, data_val) -> bool:
        """Host bookkeeping after epoch (or round) ``t`` with its summed
        (loss, fooling): history, validation, metrics, checkpoint. Returns
        True when the convergence rule ``t > 1 and |Δloss| < tol`` fires."""
        with annotate("adil/epoch_end", ("job", self._jobs, "epoch", t)):
            losses, rates = history["loss"], history["fooling_rate"]
            losses.append(sums[0] / n)
            rates.append(sums[1] / n)
            if data_val is not None and self.val_every and (t + 1) % self.val_every == 0:
                history["val_fooling"] = self._val_fooling(state.d, data_val)
            val = history["val_fooling"]
            self.metrics.log(t, loss=losses[-1], fooling=rates[-1],
                             val_fooling=val if val is not None else float("nan"))
            if self.verbose:
                print(f"[adil {tag}] epoch {t} loss {losses[-1]:.4f} "
                      f"fooling {rates[-1]:.3f} val {val}")
            if self.checkpoint_every and (t + 1) % self.checkpoint_every == 0:
                self._save_train_state(state, generator, history)
            return t > 1 and abs(losses[-1] - losses[-2]) < self.cfg.tol

    def _resume(self, state, generator, tag: str) -> dict:
        """The history so far: restored with the state and the generator
        from a train-state checkpoint where resuming applies, else empty."""
        history = {"loss": [], "fooling_rate": [], "val_fooling": None}
        if self.resume and self.checkpoint_every:
            restored = self._restore_train_state(state, generator)
            if restored is not None:
                history["loss"], history["fooling_rate"] = restored
                if self.verbose:
                    print(f"[adil {tag}] resumed at epoch {state.epoch}")
        return history

    def _learn_gd(self, data_train, data_val) -> None:
        """Joint projected AdamW over (D, v), the dataset resident on the
        device: one gather per epoch into presliced batches, then the steps;
        blocked and pipelined where those apply (see the module)."""
        twin = self._blocked_victim(as_array_dataset(data_train).image_shape)
        self._set_blocked(twin is not None)
        ds, images, labels, generator, state = self._prepare(data_train, "gd", twin)
        n = len(ds)
        step = core.make_train_step(twin or self.victim, self.cfg, "both")
        history = self._resume(state, generator, "gd")
        timer = StepTimer(warmup=1)

        def epoch():
            with annotate("adil/epoch", ("job", self._jobs, "epoch", state.epoch)):
                with annotate("adil/epoch/draw"):
                    batches = core.make_batches(generator, n, self.cfg.batch_size)
                    sliced = core.preslice_epoch(images, labels, batches)
                return core.run_epoch(step, state, *sliced)

        if self._resolve_pipeline(images, state):
            state = self._pipelined(epoch, state, generator, n, history, data_val, timer)
        else:
            for t in range(state.epoch, self.cfg.steps):
                with timer.step():
                    sums = torch.stack(epoch())
                    with annotate("sync/epoch_sums"):  # the epoch's one host read
                        sums = sums.tolist()
                if self._end_epoch(t, "gd", state, generator, sums, n, history, data_val):
                    break
        self._finish(state, ds.image_shape, history, timer)
        self._train_blocked = False

    def _pipelined(self, epoch, state, generator, n: int, history: dict, data_val,
                   timer: StepTimer) -> core.TrainState:
        """The epochs of :meth:`_learn_gd` with epoch t+1 enqueued before
        epoch t's sums are read: epoch t's bookkeeping runs on a snapshot of
        its state and generator, taken before epoch t+1 updates them. Returns
        the final state: the snapshot where the convergence rule stops at
        epoch t, as the serial loop would."""
        pending = None  # (t, read its sums, generator after its draw)
        mark = time.perf_counter()
        for t in range(state.epoch, self.cfg.steps):
            snap = _copy_state(state) if pending is not None else None
            read = _read_later(epoch())
            drawn = _copy_generator(generator)
            if pending is not None:
                t_prev, read_prev, gen_prev = pending
                stop = self._end_epoch(t_prev, "gd", snap, gen_prev, read_prev(), n,
                                       history, data_val)
                now = time.perf_counter()
                timer.record(now - mark)
                mark = now
                if stop:
                    return snap
            pending = (t, read, drawn)
        if pending is not None:
            t_prev, read_prev, gen_prev = pending
            self._end_epoch(t_prev, "gd", state, gen_prev, read_prev(), n, history, data_val)
            timer.record(time.perf_counter() - mark)
        return state

    def _host_batches(self, ds, labels_host: np.ndarray, seed: int):
        """Shuffled host batches (x, labels, idx, mask), the ragged last one
        padded with row 0 and mask 0; the order is the JAX package's."""
        bsz = self.cfg.batch_size
        for idx, x, _ in ds.batches(bsz, shuffle=True, seed=seed):
            pad = bsz - len(idx)
            mask = np.ones((bsz,), np.float32)
            if pad:
                mask[len(idx):] = 0.0
                idx = np.concatenate([idx, np.zeros((pad,), idx.dtype)])
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            yield np.asarray(x, np.float32), labels_host[idx], idx.astype(np.int64), mask

    def _learn_gd_streamed(self, data_train, data_val) -> None:
        """Joint projected AdamW with the images on the host: batches flow to
        the device through the prefetching pipeline, for datasets larger
        than the device holds. Same update as :meth:`_learn_gd`, unblocked."""
        self._set_blocked(False)
        ds = as_array_dataset(data_train)
        n = len(ds)
        generator = self._generator()
        state = self._init(ds.image_shape, n, generator, "gd")
        step = core.make_train_step(self.victim, self.cfg, "both")
        labels_host = np.empty((n,), np.int64)
        for idx, x, _ in ds.batches(self.cfg.batch_size):  # one pass for clean labels
            images = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            labels = core.predict_labels(self.victim, images)
            with annotate("sync/labels"):
                labels_host[idx] = labels.cpu().numpy()
        history = self._resume(state, generator, "gd/stream")
        timer = StepTimer(warmup=1)
        for t in range(state.epoch, self.cfg.steps):
            with timer.step(), annotate("adil/epoch_streamed", ("job", self._jobs, "epoch", t)):
                loss_sum = torch.zeros((), device=self.device)
                fool_sum = torch.zeros((), device=self.device)
                for x, labels, idx, mask in _spanned(prefetch_to_device(
                        self._host_batches(ds, labels_host, self.seed + t), size=2,
                        device=self.device), "adil/input_wait"):
                    loss, fool = step(state, x, labels, idx, mask)
                    loss_sum += loss
                    fool_sum += fool
                state.epoch += 1
                sums = torch.stack([loss_sum, fool_sum])
                with annotate("sync/epoch_sums"):
                    sums = sums.tolist()
            if self._end_epoch(t, "gd/stream", state, generator, sums, n, history, data_val):
                break
        self._finish(state, ds.image_shape, history, timer)

    def _learn_gd_from_folder(self, folder, data_val, runtime) -> None:
        """Joint projected AdamW fed from the JPEG files: the native loader
        decodes, resizes and crops on its threads, batches flow to the device
        through the prefetching pipeline, and the loader's row indices
        address v. Padding slots (label -1) and files that failed to decode
        (label -2) are masked out. Same update as :meth:`_learn_gd`, unblocked."""
        from ..runtime import HostLoader

        self._set_blocked(False)
        paths = [p for p, _ in folder.samples]
        n = len(paths)
        size = folder.image_size
        bsz = min(self.cfg.batch_size, n)
        generator = self._generator()
        state = self._init((size, size, 3), n, generator, "gd")
        step = core.make_train_step(self.victim, self.cfg, "both")

        def batches(labels, shuffle: bool, seed: int = 0):
            loader = HostLoader(runtime, paths, labels, bsz, size, shuffle=shuffle, seed=seed)
            try:
                for _, x, labs, rows in loader.iter_indexed():
                    yield x, np.maximum(labs, 0), np.maximum(rows, 0), (labs >= 0).astype(np.float32)
            finally:
                loader.close()

        # One loader pass for the clean labels, read back once. Masked slots
        # write to a spare last entry.
        labels = torch.zeros((n + 1,), dtype=torch.int64, device=self.device)
        for x, _, rows, mask in prefetch_to_device(batches(np.zeros(n, np.int64), False),
                                                   size=2, device=self.device):
            labels[torch.where(mask > 0, rows, n)] = core.predict_labels(self.victim, x)
        with annotate("sync/labels"):
            labels_host = labels[:n].cpu().numpy()

        history = self._resume(state, generator, "gd/native")
        timer = StepTimer(warmup=1)
        for t in range(state.epoch, self.cfg.steps):
            with timer.step(), annotate("adil/epoch_native", ("job", self._jobs, "epoch", t)):
                loss_sum = torch.zeros((), device=self.device)
                fool_sum = torch.zeros((), device=self.device)
                for x, labs, rows, mask in _spanned(prefetch_to_device(
                        batches(labels_host, True, self.seed + 7919 * (t + 1)), size=2,
                        device=self.device), "adil/input_wait"):
                    loss, fool = step(state, x, labs, rows, mask)
                    loss_sum += loss
                    fool_sum += fool
                state.epoch += 1
                sums = torch.stack([loss_sum, fool_sum])
                with annotate("sync/epoch_sums"):  # the epoch's one host read
                    sums = sums.tolist()
            if self._end_epoch(t, "gd/native", state, generator, sums, n, history, data_val):
                break
        self._finish(state, (size, size, 3), history, timer)

    def _learn_alter(self, data_train, data_val) -> None:
        """Alternating rounds: ``steps_inner`` epochs on v with D frozen, then
        ``steps_inner`` on D with v frozen. ``state.epoch`` counts rounds.
        The loss tracked is the last D epoch's normalized sum, as in the JAX
        package. Always unblocked."""
        self._set_blocked(False)
        ds, images, labels, generator, state = self._prepare(data_train, "alter")
        n = len(ds)
        step_v = core.make_train_step(self.victim, self.cfg, "v")
        step_d = core.make_train_step(self.victim, self.cfg, "d")
        history = self._resume(state, generator, "alter")
        timer = StepTimer(warmup=1)
        rounds = max(self.cfg.steps // self.cfg.steps_inner, 1)
        for t in range(state.epoch, rounds):
            with timer.step(), annotate("adil/round", ("job", self._jobs, "epoch", t)):
                for step in [step_v] * self.cfg.steps_inner + [step_d] * self.cfg.steps_inner:
                    batches = core.make_batches(generator, n, self.cfg.batch_size)
                    sums = core.run_epoch(step, state, *core.preslice_epoch(
                        images, labels, batches))
                state.epoch = t + 1
                sums = torch.stack(sums)
                with annotate("sync/epoch_sums"):  # the last D epoch's
                    sums = sums.tolist()
            if self._end_epoch(t, "alter", state, generator, sums, n, history, data_val):
                break
        self._finish(state, ds.image_shape, history, timer)

    def _learn_distributed(self, data_train, data_val) -> None:
        """Data-parallel joint projected AdamW over ``self.mesh``
        (``parallel.learn_dictionary_distributed``): every rank learns the
        same D, and only rank 0 writes the artifact."""
        from ..parallel import learn_dictionary_distributed

        d, v, history = learn_dictionary_distributed(
            self.victim, as_array_dataset(data_train), self.cfg, self.mesh,
            seed=self.seed, verbose=self.verbose,
            data_val=as_array_dataset(data_val) if data_val is not None else None,
            val_every=self.val_every or 0, d_init=self._load_warm_start(),
            checkpoint_every=self.checkpoint_every or 0, cache=self.cache,
            ckpt_key=self._train_ckpt_key(distributed=True), resume=self.resume,
            blocked=self.blocked)
        self.trained_blocked = bool(history["blocked"])
        self.timing = history.pop("timing")
        self._save(d, v, history)

    def _finish(self, state, image_shape, history: dict, timer: StepTimer) -> None:
        self.timing = timer.summary()
        self._save(self._present_d(state.d, image_shape), state.v, history)
        if self.checkpoint_every:
            self._clear_train_state()

    # -- mid-training checkpoint: the port's own kind, so that a JAX
    # -- train-state checkpoint in a shared cache is never resumed here. A
    # -- blocked run's D and moments are column-permuted: its kind is its own.

    def _train_ckpt_key(self, distributed: bool = False) -> dict:
        if distributed:
            kind = "dp_train_state_torch"
        else:
            kind = "train_state_s2d_torch" if self._train_blocked else "train_state_torch"
        return dict(model=self.model_name, kind=kind)

    def _save_train_state(self, state: core.TrainState, generator: torch.Generator,
                          history: dict) -> None:
        payload = {
            "d": state.d, "v": state.v,
            "d_mu": state.d_mu, "d_nu": state.d_nu,
            "v_mu": state.v_mu, "v_nu": state.v_nu,
            "d_count": state.d_count, "v_count": state.v_count, "epoch": state.epoch,
            "rng": generator.get_state(),
            "loss": np.asarray(history["loss"], np.float64),
            "fooling": np.asarray(history["fooling_rate"], np.float64),
        }
        with annotate("sync/checkpoint"):  # the state's tensors, read to the host
            self.cache.save(payload, "ImageNet", **self._train_ckpt_key())

    def _restore_train_state(self, state: core.TrainState, generator: torch.Generator):
        """Load a train-state checkpoint into ``state`` and ``generator`` in
        place; returns its (losses, fooling rates), or None without one."""
        payload = self.cache.load("ImageNet", **self._train_ckpt_key())
        if payload is None:
            return None
        for name in ("d", "v", "d_mu", "d_nu", "v_mu", "v_nu"):
            dst = getattr(state, name)
            dst.copy_(torch.as_tensor(payload[name]).reshape(dst.shape))
        state.d_count = int(payload["d_count"])
        state.v_count = int(payload["v_count"])
        state.epoch = int(payload["epoch"])
        generator.set_state(torch.as_tensor(payload["rng"], dtype=torch.uint8))
        return list(payload["loss"]), list(payload["fooling"])

    def _clear_train_state(self) -> None:
        self.cache.remove("ImageNet", **self._train_ckpt_key())

    def _save(self, d: torch.Tensor, v: torch.Tensor, history: dict) -> None:
        """Save the artifact (D in its (K, H, W, C) presentation shape, v and
        the history; None entries are left out) and keep D. With a mesh only
        rank 0 writes."""
        if self.mesh is None or dist.get_rank() == 0:
            payload = {"d": d, "v": v}
            payload.update({k: np.asarray(val) for k, val in history.items()
                            if val is not None})
            with annotate("sync/save"):  # D and v, read to the host
                self.cache.save(payload, "ImageNet", model=self.model_name)
        self.dictionary = d.contiguous()
        self.history = history

    # -- inference --------------------------------------------------------

    def _load_dictionary(self) -> torch.Tensor:
        if self.dictionary is not None:
            return self.dictionary
        payload = self.cache.load("ImageNet", model=self.model_name)
        if payload is None:
            raise FileNotFoundError(
                f"no trained dictionary at "
                f"{self.cache.path('ImageNet', model=self.model_name)}")
        self.dictionary = torch.as_tensor(
            payload["d"], dtype=torch.float32, device=self.device).contiguous()
        return self.dictionary

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, dtype=torch.float32, device=self.device).contiguous()

    def _blocked_dict(self, d: torch.Tensor) -> torch.Tensor:
        """The blocked copy of the (fixed) dictionary, cached per D."""
        cached = self._blocked_d_cache
        if cached is None or cached[0] is not d:
            cached = self._blocked_d_cache = (d, space_to_depth(d))
        return cached[1]

    def _blocked_supervised(self, solver, d: torch.Tensor, images: torch.Tensor):
        """``solver`` (a supervised solver of ``adil_core``) run through the
        blocked twin, or None where the twin does not apply. The Gram matrix
        and so D's pseudo-inverse, every clamp and every squared norm are
        invariant under the column permutation, so this is the standard
        solve in another layout. Unsupervised sampling stays standard: it
        takes no input gradient."""
        twin = self._blocked_victim(tuple(images.shape[1:]))
        if twin is None:
            return None
        return depth_to_space(solver(twin, self._blocked_dict(d), space_to_depth(images),
                                     self.cfg))

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Attack a batch with the memoized dictionary, by ``attack`` mode;
        where there is none yet, learn one on this batch first."""
        self._calls += 1
        with annotate("adil/forward", ("forward", self._calls)):
            if not self.is_trained:
                self.learn_dictionary((images.detach().cpu().numpy(),
                                       labels.detach().cpu().numpy()), None)
            d = self._load_dictionary()
            images = self._images(images)
            if self.attack_mode == "supervised":
                adv = self._blocked_supervised(core.supervised_ddrague, d, images)
                if adv is not None:
                    return adv
                return core.supervised_ddrague(self.victim, d, images, self.cfg)
            self._rng_calls += 1
            generator = torch.Generator(device=images.device)
            generator.manual_seed(self.seed * 1_000_003 + self._rng_calls)
            return core.unsupervised_sample(self.victim, d, images, generator, self.cfg)

    def forward_supervised_adamw(self, images: torch.Tensor) -> torch.Tensor:
        """The alternative supervised solver: AdamW on the codes."""
        self._calls += 1
        with annotate("adil/forward", ("forward", self._calls)):
            d = self._load_dictionary()
            images = self._images(images)
            adv = self._blocked_supervised(core.supervised_adamw_codes, d, images)
            if adv is not None:
                return adv
            return core.supervised_adamw_codes(self.victim, d, images, self.cfg)
