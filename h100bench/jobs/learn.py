"""Dictionary learning: one ``ADIL.learn_dictionary`` job on its resident
joint ``gd`` path, as long as users run it.

The mix gives the job: ``images`` seeded images handed over as a host
numpy array (as a blob from ``cli.dataset`` is), ``epochs`` (the length of
the job: ``ADIL``'s and ``cli.demo``'s default of 500), ``batch`` and
``pipeline_epochs``. The job runs in a thread of its own, held before the
first training pass of each epoch until the next epoch is asked for
(:class:`Gate`). Set-up starts it: the copy to the card, the draws and
the clean-label pass, timed as the job's start (``host_s["job_start"]``),
then its first epoch, whose first ``REPLAYED`` training passes are
recorded. A unit is one more epoch of the same job; its work is its
image-steps. The window so sees a stretch of the job's steady state, where
its hundreds of epochs spend their time; the job is stopped after it, so
its end (the artifact's save, once a job) never runs.

The check judges the job's first steps from their recorded passes against
the plain job of the same seed and images (``reference.learn.replay``).
"""

from __future__ import annotations

import math
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from .. import inputs, program
from ..harness import Tape, lower_precision, on_device, sync
from ..reference import learn as plain

REPLAYED = 3  # steps judged from the program's own passes


class Stopped(Exception):
    """Raised in the job's thread to end the job once the window has closed."""


class Gate:
    """One ``learn_dictionary`` call in a thread of its own, held before
    the first training pass of each epoch (every ``per_epoch``-th pass of
    ``victim`` that records for an input gradient) until :meth:`epoch`
    lets it run on. Only one of the two threads works at a time."""

    def __init__(self, victim, per_epoch: int, call):
        self.per_epoch, self.passes = per_epoch, 0
        self.held, self.go = threading.Semaphore(0), threading.Semaphore(0)
        self.stopping, self.finished, self.error = False, False, None
        self._handle = victim.register_forward_pre_hook(self._pre)
        self.thread = threading.Thread(target=self._run, args=(call,), daemon=True)
        self.thread.start()

    def _pre(self, module, args):
        if not (torch.is_grad_enabled() and args[0].requires_grad):
            return
        if self.passes % self.per_epoch == 0:
            self.held.release()
            self.go.acquire()
            if self.stopping:
                raise Stopped
        self.passes += 1

    def _run(self, call):
        try:
            call()
        except Stopped:
            pass
        except BaseException as e:  # handed to the harness's thread
            self.error = e
        finally:
            self.finished = True
            self.held.release()

    def wait(self) -> None:
        """Until the job is held before an epoch; raises where it ended."""
        self.held.acquire()
        if self.finished:
            self.thread.join()
            if self.error is not None:
                raise RuntimeError("the learning job failed") from self.error
            raise RuntimeError("the learning job ended early: its convergence rule fired")

    def epoch(self) -> None:
        """Lets the held job run one epoch, until it is held before the next."""
        self.go.release()
        self.wait()

    def stop(self) -> None:
        self.stopping = True
        self.go.release()
        self.thread.join()
        self._handle.remove()


def setup(run) -> SimpleNamespace:
    cfg, mix, dev = run.config, run.mix, run.device
    params = inputs.weights(cfg, run.seed, dev)
    with record_function("bench/images"):
        images = inputs.images(run.seed, "train", mix["images"], cfg["input_size"], dev)
        host = images.cpu().numpy()
        del images
    params = {k: v.cpu() for k, v in params.items()}  # handed over as a checkpoint is
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # from here on, the program's own
    victim = program.victim(cfg, params, dev)
    seed = inputs.sub_seed(run.seed, "job", bits=31)
    adil = program.adil(victim, cfg, mix, program.ArtifactCache(run.workdir), seed,
                        steps=mix["epochs"], pipeline_epochs=mix["pipeline_epochs"])
    labels = np.zeros(len(host), np.int64)
    tape = Tape(victim, limit=REPLAYED + 1, only_grad=True, host=True)
    start = time.perf_counter()
    with record_function("bench/job_start"):
        gate = Gate(victim, math.ceil(len(host) / mix["batch"]),
                    lambda: adil.learn_dictionary((host, labels)))
        gate.wait()
        sync(dev)
    job_start = time.perf_counter() - start
    with record_function("bench/epoch"):
        gate.epoch()  # the first epoch: every shape of the job; its first steps recorded
    tape.close()
    return SimpleNamespace(run=run, victim=victim, net=victim.net, adil=adil, gate=gate,
                           images=host, params=params, seed=seed, records=tape.records,
                           epochs=0, host_s={"job_start": job_start})


def unit(st, i: int) -> None:
    with record_function("bench/epoch"):
        st.gate.epoch()
    st.epochs = i + 1


def work(st) -> dict:
    return {"train_images_per_s": st.epochs * len(st.images)}


def stop(st) -> list:
    """Ends the job and frees the program; returns the recorded first
    passes on the card."""
    st.gate.stop()
    st.adil = st.victim = st.net = st.gate = None
    if st.run.device.type == "cuda":
        torch.cuda.empty_cache()
    return on_device(st.records, st.run.device)


def reference_inputs(st) -> tuple:
    """The plain victim and the images, on the card."""
    dev, cfg = st.run.device, st.run.config
    model = inputs.architecture(cfg).model({k: v.to(dev) for k, v in st.params.items()}, cfg)
    return model, torch.from_numpy(st.images).to(dev)


def judge(st, records: list, model, images) -> dict:
    return plain.replay(records, model, images, st.seed, st.run.config["attack"],
                        st.run.mix["batch"])


def check(st, wanted) -> dict:
    """``wanted`` is not needed: every number the replay reads is one the
    cell compares."""
    print(f"h100bench: the window ran epochs 2-{st.epochs + 1} of the job's "
          f"{st.run.mix['epochs']}", file=sys.stderr)
    records = stop(st)
    return judge(st, records, *reference_inputs(st))


def calibrate(st, control: bool) -> dict:
    """The program's readings and, with ``control``, those of the plain
    job's first epoch in TF32 in the program's place."""
    records = stop(st)
    model, images = reference_inputs(st)
    out = {"program": judge(st, records, model, images)}
    if control:
        tape = Tape(limit=REPLAYED + 1, only_grad=True)
        with lower_precision():
            plain.learn(tape.wrap(model), images, st.seed, st.run.config["attack"], 1,
                        st.run.mix["batch"])
        out["control"] = judge(st, tape.records, model, images)
    return out
