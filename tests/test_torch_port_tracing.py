"""The port's span recorder (``utils.profiling``): nothing recorded without
a profiler; spans from every thread under one, with their parents, units
and self times; their clock against the profiler's own events; the spans
of threads the profiler does not see written into ``trace``'s Chrome
trace; the spans and the blocking reads of one DDrague call, one sampled
call and one resident epoch on the tiny victim. The test marked ``gpu``
holds the ``sync/*`` spans to every synchronising call torch reports on
the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_tracing.py
"""

import contextlib
import json
import statistics
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache, annotate, profiling, trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def sync_counts() -> dict:
    return {name: t.count for name, t in profiling.totals().items() if name.startswith("sync/")}


def test_nothing_is_recorded_without_a_profiler():
    span = annotate("test/off", ("unit", 1))
    assert isinstance(span, contextlib.nullcontext)
    with span, annotate("test/inner"):
        pass
    assert profiling.spans() == [] and profiling.totals() == {}


def test_spans_of_a_held_second_thread_with_parents_units_and_self_times():
    # As the benchmark's learning job runs: its own thread, held inside a
    # step while the main thread works, then let run on.
    held, go = threading.Semaphore(0), threading.Semaphore(0)

    def job():
        with annotate("job/epoch", ("job", 1, "epoch", 0)):
            busy(0.005)
            with annotate("job/step"):
                held.release()
                go.acquire()  # held, as between the benchmark's units
                busy(0.01)
                with annotate("sync/test_read"):
                    busy(0.002)

    with cpu_profile():
        with annotate("main/window"):
            worker = threading.Thread(target=job, name="job-thread")
            worker.start()
            held.acquire()
            time.sleep(0.05)
            go.release()
            worker.join(timeout=60)
    assert not worker.is_alive()
    by_name = {s.name: s for s in profiling.spans()}
    assert set(by_name) == {"main/window", "job/epoch", "job/step", "sync/test_read"}
    epoch, step, read = by_name["job/epoch"], by_name["job/step"], by_name["sync/test_read"]
    assert (epoch.parent, step.parent, read.parent) == (None, epoch.id, step.id)
    assert epoch.unit == step.unit == read.unit == ("job", 1, "epoch", 0)
    assert {epoch.thread_name, step.thread_name, read.thread_name} == {"job-thread"}
    assert epoch.thread == worker.native_id != by_name["main/window"].thread
    assert by_name["main/window"].seen and not (epoch.seen or step.seen or read.seen)
    assert epoch.start_ns <= step.start_ns <= read.start_ns <= read.end_ns <= step.end_ns \
        <= epoch.end_ns
    totals = profiling.totals()
    for name, s in by_name.items():
        assert totals[name].count == 1
        assert totals[name].total_s == pytest.approx((s.end_ns - s.start_ns) / 1e9)
    assert totals["job/epoch"].self_s == pytest.approx(
        totals["job/epoch"].total_s - totals["job/step"].total_s)
    assert totals["job/step"].self_s == pytest.approx(
        totals["job/step"].total_s - totals["sync/test_read"].total_s)
    assert totals["job/step"].self_s >= 0.06  # held 50 ms, then worked 10 ms
    assert [s.self_ns for s in (epoch, step, read)] == [
        round(t.self_s * 1e9) for t in (totals[n] for n in ("job/epoch", "job/step",
                                                            "sync/test_read"))]


def test_a_span_and_its_profiler_range_line_up_on_the_profilers_clock():
    with cpu_profile() as prof:
        with annotate("test/warm-up"):
            pass
        for i in range(20):
            with annotate(f"test/span{i}"):
                time.sleep(0.001)
    ours = {s.name: s for s in profiling.spans()}
    twins = {e.name(): e for e in prof.profiler.kineto_results.events()
             if e.name().startswith("test/span")}
    assert set(twins) == {n for n in ours if n.startswith("test/span")}
    starts = [abs(ours[n].start_ns - e.start_ns()) for n, e in twins.items()]
    ends = [abs(ours[n].end_ns - (e.start_ns() + e.duration_ns())) for n, e in twins.items()]
    assert statistics.median(starts) < 1e5 and statistics.median(ends) < 1e5
    assert max(starts + ends) < 1e6


def test_trace_writes_the_unseen_threads_spans_on_its_time_base(tmp_path):
    def job():
        with annotate("job/work", ("job", 7)):
            time.sleep(0.005)

    with trace(str(tmp_path / "t")):
        with annotate("main/before"):
            time.sleep(0.005)
        worker = threading.Thread(target=job, name="job-thread")
        worker.start()
        worker.join(timeout=60)
        with annotate("main/after"):
            time.sleep(0.005)
    assert not worker.is_alive()
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    named = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith(("main/", "job/")):
            named.setdefault(e["name"], []).append(e)
    assert {n: len(es) for n, es in named.items()} == {"main/before": 1, "job/work": 1,
                                                        "main/after": 1}
    before, work, after = named["main/before"][0], named["job/work"][0], named["main/after"][0]
    assert work["tid"] == worker.native_id and work["args"]["unit"] == "job 7"
    assert before["ts"] + before["dur"] <= work["ts"] <= work["ts"] + work["dur"] <= after["ts"]
    assert work["dur"] >= 5e3
    assert any(e.get("ph") == "M" and e.get("tid") == worker.native_id
               and e["args"]["name"] == "job-thread" for e in events)


def tiny_attack(tmp_path, **kw) -> ADIL:
    victim = create_model("tiny", num_classes=10, device="cpu")
    d = np.random.RandomState(0).uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    cache = ArtifactCache(str(tmp_path))
    cache.save({"d": d}, "ImageNet", model="tiny")
    return ADIL(victim, n_atoms=6, batch_size=4, cache=cache, model_name="tiny",
                loss="logits", **kw)


def grad_passes(victim) -> list:
    passes = []
    victim.register_forward_hook(
        lambda m, args, out: passes.append(torch.is_grad_enabled() and args[0].requires_grad))
    return passes


def test_a_ddrague_call_records_its_steps_and_their_reads(tmp_path):
    attack = tiny_attack(tmp_path, steps_inference=4)
    passes = grad_passes(attack.victim)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with cpu_profile():
        attack(x, torch.zeros(4, dtype=torch.long))
    totals = profiling.totals()
    counts = {name: t.count for name, t in totals.items()}
    assert sum(passes) == 4  # no early stop: four solver iterations
    assert counts == {"adil/forward": 1, "adil/ddrague/labels": 1, "sync/dict_pinv": 1,
                      "adil/ddrague/step": 4, "sync/step_delta": 4, "adil/readoff": 1}
    assert {s.unit for s in profiling.spans()} == {("forward", 1)}
    step = totals["adil/ddrague/step"]
    assert 0 < step.self_s < step.total_s


def test_a_sampled_call_records_its_trials_and_no_read(tmp_path):
    attack = tiny_attack(tmp_path, attack="unsupervised", trials=3)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with cpu_profile():
        attack(x, torch.zeros(4, dtype=torch.long))
        attack(x, torch.zeros(4, dtype=torch.long))
    counts = {name: t.count for name, t in profiling.totals().items()}
    assert counts == {"adil/forward": 2, "adil/sample/labels": 2, "adil/sample/draws": 2,
                      "adil/sample/trial": 6}
    assert {s.unit for s in profiling.spans()} == {("forward", 1), ("forward", 2)}


@pytest.mark.parametrize("pipeline, read", [(True, "sync/read_later"),
                                            (False, "sync/epoch_sums")])
def test_a_resident_epoch_records_a_step_a_batch_and_one_read(tmp_path, pipeline, read):
    attack = tiny_attack(tmp_path, steps=1, pipeline_epochs=pipeline)
    images = np.random.RandomState(1).rand(8, 32, 32, 3).astype(np.float32)
    with cpu_profile():
        attack.learn_dictionary((images, np.zeros(8, np.int64)))
    counts = {name: t.count for name, t in profiling.totals().items()}
    assert counts["adil/step"] == 2 and counts["adil/epoch"] == 1
    assert counts["adil/epoch_end"] == 1 and counts["adil/epoch/draw"] == 1
    assert sync_counts() == {read: 1, "sync/save": 1}  # the epoch's read; the job's save
    units = {s.name: s.unit for s in profiling.spans()}
    assert units["adil/step"] == units["adil/epoch_end"] == ("job", 1, "epoch", 0)
    assert units["adil/prepare/labels"] == ("job", 1, "prepare")


class SyncCount:
    """Counts the synchronising calls torch reports while ``counting``
    (``set_sync_debug_mode("warn")``), and the explicit
    ``torch.cuda.Event.synchronize`` calls, which it does not report."""

    def __init__(self, monkeypatch):
        self.explicit, self.on = 0, False
        original = torch.cuda.Event.synchronize

        def counted(event):
            self.explicit += self.on
            return original(event)

        monkeypatch.setattr(torch.cuda.Event, "synchronize", counted)

    @contextlib.contextmanager
    def counting(self):
        self.explicit, self.reported, self.on = 0, 0, True
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)
                self.on = False
                self.reported = sum("synchronizing CUDA operation" in str(w.message)
                                    for w in caught)


@pytest.mark.gpu
def test_the_sync_spans_are_every_synchronising_call_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    victim = create_model("resnet50", num_classes=10, input_size=32, device="cuda")
    cache = ArtifactCache(str(tmp_path))
    cache.save({"d": torch.rand(6, 32, 32, 3, device="cuda") * 2 - 1}, "ImageNet", model="r50")
    x = torch.rand(4, 32, 32, 3, device="cuda")
    labels = torch.zeros(4, dtype=torch.long, device="cuda")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    syncs = SyncCount(monkeypatch)
    passes = grad_passes(victim)
    for mode in ("supervised", "unsupervised"):
        attack = ADIL(victim, n_atoms=6, batch_size=4, cache=cache, model_name="r50",
                      loss="logits", attack=mode, trials=3)
        attack(x, labels)  # the first call: its first uses outside the count
        torch.cuda.synchronize()
        profiling.reset()
        passes.clear()
        with profile(activities=activities):
            with syncs.counting():
                attack(x, labels)
        steps = sum(passes)
        if mode == "supervised":
            assert 1 <= steps <= 30
            assert sync_counts() == {"sync/dict_pinv": 1, "sync/step_delta": steps}
            assert (syncs.reported, syncs.explicit) == (steps + 1, 0)
        else:
            assert steps == 0 and sync_counts() == {}
            assert (syncs.reported, syncs.explicit) == (0, 0)

    # One resident epoch, from its first training pass to the job's end
    # (its save, outside the count), pipelined and serial.
    images = np.random.RandomState(1).rand(8, 32, 32, 3).astype(np.float32)
    for pipeline, read, explicit in ((True, "sync/read_later", 1),
                                     (False, "sync/epoch_sums", 0)):
        attack = ADIL(victim, steps=1, n_atoms=6, batch_size=4, cache=ArtifactCache(
            str(tmp_path / f"job-{pipeline}")), model_name="r50", loss="logits",
                      pipeline_epochs=pipeline)
        stack, got = contextlib.ExitStack(), {}

        def first_pass(module, args):
            if torch.is_grad_enabled() and args[0].requires_grad and not got:
                profiling.reset()
                got["on"] = stack.enter_context(syncs.counting())

        finish = attack._finish

        def finish_uncounted(*args):
            stack.close()
            got["spans"] = sync_counts()
            return finish(*args)

        monkeypatch.setattr(attack, "_finish", finish_uncounted)
        handle = victim.register_forward_pre_hook(first_pass)
        try:
            with profile(activities=activities):
                attack.learn_dictionary((images, np.zeros(8, np.int64)))
        finally:
            handle.remove()
            stack.close()
        assert got["spans"] == {read: 1}
        assert (syncs.reported, syncs.explicit) == (1 - explicit, explicit)
