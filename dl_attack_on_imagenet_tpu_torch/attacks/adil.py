"""ADIL — Adversarial Dictionary Learning attack.

Port of ``dl_attack_on_imagenet_tpu/attacks/adil.py``: the constructor, the
memoized dictionary artifact, dictionary learning (``method="gd"``, the
joint projected AdamW, with the dataset resident on the device, streamed
from the host, or decoded from a folder of JPEGs by the native loader, and
``method="alter"``, alternating v and D phases), the step-level train-state
checkpoint, ``forward`` (supervised DDrague or unsupervised best-of-trials
sampling, learning first where no dictionary exists) and
``forward_supervised_adamw``.

Not ported yet, and refused with ``NotImplementedError``: ``mesh`` (data
parallel training), ``blocked=True``, ``pipeline_epochs=True`` and
``perturb_dtype="bfloat16"``. ``blocked`` and ``pipeline_epochs`` take
their defaults and ``False``, and train on the standard serial loop, whose
trajectory the JAX package's own tests prove equal to theirs.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..data import as_array_dataset, prefetch_to_device
from ..models import VictimModel
from ..utils import ArtifactCache, MetricLogger, StepTimer, annotate
from . import adil_core as core
from .adil_core import AdilConfig
from .base import Attack


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")


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
        if mesh is not None:
            raise _not_ported("data-parallel training (mesh=)", "6")
        if blocked not in ("auto", False):
            raise _not_ported("blocked=True (the space-to-depth layout)", "12")
        if pipeline_epochs not in ("auto", False):
            raise _not_ported("pipeline_epochs=True", "12")
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
        self.warm_start = warm_start
        self.model_name = model_name or victim.name
        self.cache = cache or ArtifactCache("trained_dicts")
        self.seed = seed
        self.val_every = val_every
        self.verbose = verbose
        self.stream = stream
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.metrics = MetricLogger(metrics_log)
        self.dictionary: Optional[torch.Tensor] = None
        self.history: dict = {}
        self.timing: dict = {}
        self._rng_calls = 0  # per-call seed offset so equal batches differ

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
        if self._is_path_dataset(data_train):
            data_train, data_val = self._dispatch_folder(data_train, data_val)
            if data_train is None:
                return  # trained from the JPEG files
        if self.method == "alter":
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
        builds and ``stream`` is not False; otherwise decode the folder into
        arrays (with PIL where the loader is missing) and go on with those.
        Returns the (data_train, data_val) to go on with, or (None, None)
        once training is done."""
        from ..runtime import get_runtime

        runtime = get_runtime()
        if data_val is not None and self._is_path_dataset(data_val):
            data_val = data_val.materialize(runtime=runtime)
        if runtime is not None and self.method != "alter" and self.stream is not False:
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

    def _prepare(self, data_train, mode: str):
        """Dataset, its images and clean labels on the device, generator and
        fresh state for a resident training run."""
        ds = as_array_dataset(data_train)
        images = torch.as_tensor(ds.images, dtype=torch.float32, device=self.device).contiguous()
        generator = self._generator()
        state = self._init(ds.image_shape, len(ds), generator, mode)
        labels = core.predict_labels(self.victim, images)
        return ds, images, labels, generator, state

    def _val_fooling(self, d: torch.Tensor, data_val) -> float:
        """Validation: optimize fresh codes on the val set with D frozen and
        count how many fool the victim, as a share of the set.

        A ragged last batch is padded by cycling its rows, as the JAX
        package does to keep one compiled shape, and its count is scaled by
        its real share of the padded batch.
        """
        ds = as_array_dataset(data_val)
        d = core.d_image(d, ds.image_shape)
        b = self.cfg.batch_size
        total = 0.0
        for _, x, _ in ds.batches(b):
            k = x.shape[0]
            if k < b:
                x = np.concatenate([np.asarray(x)] * -(-b // k))[:b]
            images = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            fooled = core.supervised_adamw_codes(self.victim, d, images, self.cfg,
                                                 return_fooling=True)
            total += float(fooled) * (k / b if k < b else 1.0)
        return total / len(ds)

    def _end_epoch(self, t: int, tag: str, state, generator, sums, n: int,
                   history: dict, data_val) -> bool:
        """Host bookkeeping after epoch (or round) ``t`` with its summed
        (loss, fooling): history, validation, metrics, checkpoint. Returns
        True when the convergence rule ``t > 1 and |Δloss| < tol`` fires."""
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
        device: one gather per epoch into presliced batches, then the steps."""
        ds, images, labels, generator, state = self._prepare(data_train, "gd")
        n = len(ds)
        step = core.make_train_step(self.victim, self.cfg, "both")
        history = self._resume(state, generator, "gd")
        timer = StepTimer(warmup=1)
        for t in range(state.epoch, self.cfg.steps):
            with timer.step(), annotate("adil/epoch"):
                batches = core.make_batches(generator, n, self.cfg.batch_size)
                sums = torch.stack(core.run_epoch(step, state, *core.preslice_epoch(
                    images, labels, batches))).tolist()  # the epoch's one host read
            if self._end_epoch(t, "gd", state, generator, sums, n, history, data_val):
                break
        self._finish(state, ds.image_shape, history, timer)

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
        than the device holds. Same update as :meth:`_learn_gd`."""
        ds = as_array_dataset(data_train)
        n = len(ds)
        generator = self._generator()
        state = self._init(ds.image_shape, n, generator, "gd")
        step = core.make_train_step(self.victim, self.cfg, "both")
        labels_host = np.empty((n,), np.int64)
        for idx, x, _ in ds.batches(self.cfg.batch_size):  # one pass for clean labels
            images = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            labels_host[idx] = core.predict_labels(self.victim, images).cpu().numpy()
        history = self._resume(state, generator, "gd/stream")
        timer = StepTimer(warmup=1)
        for t in range(state.epoch, self.cfg.steps):
            with timer.step(), annotate("adil/epoch_streamed"):
                loss_sum = torch.zeros((), device=self.device)
                fool_sum = torch.zeros((), device=self.device)
                for x, labels, idx, mask in prefetch_to_device(
                        self._host_batches(ds, labels_host, self.seed + t), size=2,
                        device=self.device):
                    loss, fool = step(state, x, labels, idx, mask)
                    loss_sum += loss
                    fool_sum += fool
                state.epoch += 1
                sums = torch.stack([loss_sum, fool_sum]).tolist()
            if self._end_epoch(t, "gd/stream", state, generator, sums, n, history, data_val):
                break
        self._finish(state, ds.image_shape, history, timer)

    def _learn_gd_from_folder(self, folder, data_val, runtime) -> None:
        """Joint projected AdamW fed from the JPEG files: the native loader
        decodes, resizes and crops on its threads, batches flow to the device
        through the prefetching pipeline, and the loader's row indices
        address v. Padding slots (label -1) and files that failed to decode
        (label -2) are masked out. Same update as :meth:`_learn_gd`."""
        from ..runtime import HostLoader

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
        labels_host = labels[:n].cpu().numpy()

        history = self._resume(state, generator, "gd/native")
        timer = StepTimer(warmup=1)
        for t in range(state.epoch, self.cfg.steps):
            with timer.step(), annotate("adil/epoch_native"):
                loss_sum = torch.zeros((), device=self.device)
                fool_sum = torch.zeros((), device=self.device)
                for x, labs, rows, mask in prefetch_to_device(
                        batches(labels_host, True, self.seed + 7919 * (t + 1)), size=2,
                        device=self.device):
                    loss, fool = step(state, x, labs, rows, mask)
                    loss_sum += loss
                    fool_sum += fool
                state.epoch += 1
                sums = torch.stack([loss_sum, fool_sum]).tolist()  # the epoch's one host read
            if self._end_epoch(t, "gd/native", state, generator, sums, n, history, data_val):
                break
        self._finish(state, (size, size, 3), history, timer)

    def _learn_alter(self, data_train, data_val) -> None:
        """Alternating rounds: ``steps_inner`` epochs on v with D frozen, then
        ``steps_inner`` on D with v frozen. ``state.epoch`` counts rounds.
        The loss tracked is the last D epoch's normalized sum, as in the JAX
        package."""
        ds, images, labels, generator, state = self._prepare(data_train, "alter")
        n = len(ds)
        step_v = core.make_train_step(self.victim, self.cfg, "v")
        step_d = core.make_train_step(self.victim, self.cfg, "d")
        history = self._resume(state, generator, "alter")
        timer = StepTimer(warmup=1)
        rounds = max(self.cfg.steps // self.cfg.steps_inner, 1)
        for t in range(state.epoch, rounds):
            with timer.step(), annotate("adil/round"):
                for step in [step_v] * self.cfg.steps_inner + [step_d] * self.cfg.steps_inner:
                    batches = core.make_batches(generator, n, self.cfg.batch_size)
                    sums = core.run_epoch(step, state, *core.preslice_epoch(
                        images, labels, batches))
                state.epoch = t + 1
                sums = torch.stack(sums).tolist()  # the last D epoch's
            if self._end_epoch(t, "alter", state, generator, sums, n, history, data_val):
                break
        self._finish(state, ds.image_shape, history, timer)

    def _finish(self, state, image_shape, history: dict, timer: StepTimer) -> None:
        self.timing = timer.summary()
        self._save(core.d_image(state.d, image_shape), state.v, history)
        if self.checkpoint_every:
            self._clear_train_state()

    # -- mid-training checkpoint: the port's own kind, so that a JAX
    # -- train-state checkpoint in a shared cache is never resumed here.

    def _train_ckpt_key(self) -> dict:
        return dict(model=self.model_name, kind="train_state_torch")

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
        the history; None entries are left out) and keep D."""
        payload = {"d": d, "v": v}
        payload.update({k: np.asarray(val) for k, val in history.items() if val is not None})
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

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Attack a batch with the memoized dictionary, by ``attack`` mode;
        where there is none yet, learn one on this batch first."""
        if not self.is_trained:
            self.learn_dictionary((images.detach().cpu().numpy(),
                                   labels.detach().cpu().numpy()), None)
        d = self._load_dictionary()
        images = self._images(images)
        if self.attack_mode == "supervised":
            return core.supervised_ddrague(self.victim, d, images, self.cfg)
        self._rng_calls += 1
        generator = torch.Generator(device=images.device)
        generator.manual_seed(self.seed * 1_000_003 + self._rng_calls)
        return core.unsupervised_sample(self.victim, d, images, generator, self.cfg)

    def forward_supervised_adamw(self, images: torch.Tensor) -> torch.Tensor:
        """The alternative supervised solver: AdamW on the codes."""
        d = self._load_dictionary()
        return core.supervised_adamw_codes(self.victim, d, self._images(images), self.cfg)
