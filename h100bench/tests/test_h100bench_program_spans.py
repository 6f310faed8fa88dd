"""The readers of the program's spans and sync counts (``host_syncs.*``,
``host_step_ms.*``): fixed totals through a stub run context; nothing read
off the card, without the recorder (a program that lacks it) or without the
spans; and the spans of a tiny learning job run as the benchmark runs it,
in a thread of its own held between epochs.

    python -m pytest h100bench/tests -q -p no:cacheprovider   (from the root)
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dl_attack_on_imagenet_tpu_torch.attacks import ADIL
from dl_attack_on_imagenet_tpu_torch.models import create_model
from dl_attack_on_imagenet_tpu_torch.utils import ArtifactCache, profiling
from h100bench import harness
from h100bench.jobs.learn import Gate

torch.set_num_threads(1)
Total = profiling.Total
NAMES = ("host_syncs.attack", "host_syncs.learn", "host_step_ms.attack", "host_step_ms.learn")
DDRAGUE = {"adil/forward": Total(2, 4.0, 0.1), "adil/ddrague/step": Total(60, 3.8, 0.9),
           "sync/step_delta": Total(60, 2.9, 2.9), "sync/dict_pinv": Total(2, 0.1, 0.1)}
SAMPLING = {"adil/forward": Total(3, 0.9, 0.01), "adil/sample/trial": Total(30, 0.8, 0.3)}
LEARN = {"adil/step": Total(60, 6.0, 6.0), "adil/epoch": Total(3, 6.2, 0.1),
         "sync/read_later": Total(3, 0.2, 0.2)}


def span(name: str, self_ms: float):
    return profiling.Span(0, None, name, None, 1, "t", 0, 0, int(self_ms * 1e6), False)


# Self times: a step's, and two epochs' first steps, held by the benchmark.
STEPS = [span("adil/step", ms) for ms in (12.0, 11.0, 2100.0, 13.0, 12.5, 1900.0, 11.5)]
SOLVER = [span("adil/ddrague/step", ms) for ms in (7.0, 6.0, 8.0)] + \
    [span("adil/sample/trial", 3.0), span("sync/step_delta", 60.0), span("adil/forward", 1.0)]


def reader(name):
    return harness.load_metric(harness.BENCH_DIR, name)


def ctx(units: int, on_device: bool = True):
    return SimpleNamespace(units=units, on_device=on_device)


@pytest.fixture
def fixed(monkeypatch):
    def use(totals: dict, spans: list = ()):
        monkeypatch.setattr(profiling, "totals", lambda: dict(totals))
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return use


def test_readers_of_fixed_totals_and_spans(fixed):
    fixed(DDRAGUE, SOLVER)
    assert reader("host_syncs.attack")(ctx(2)) == 31
    assert reader("host_step_ms.attack")(ctx(2)) == pytest.approx(6.5)
    fixed(SAMPLING, SOLVER[3:])
    assert reader("host_syncs.attack")(ctx(3)) == 0
    assert reader("host_step_ms.attack")(ctx(3)) == pytest.approx(3.0)
    fixed(LEARN, STEPS)
    assert reader("host_syncs.learn")(ctx(3)) == 1
    assert reader("host_step_ms.learn")(ctx(3)) == pytest.approx(12.5)


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_off_the_card_or_without_the_spans(fixed, monkeypatch, name):
    fixed({**DDRAGUE, **SAMPLING, **LEARN}, STEPS + SOLVER)
    assert reader(name)(ctx(3, on_device=False)) is None
    fixed({}, [])
    assert reader(name)(ctx(3)) is None
    monkeypatch.delattr(profiling, "totals")  # a program without the recorder
    monkeypatch.delattr(profiling, "spans")
    assert reader(name)(ctx(3)) is None


def test_a_learning_job_held_between_epochs_in_its_thread(tmp_path):
    """As the learn cell runs it: set-up unrecorded, two units in the traced
    window, the job stopped after it; a step a batch and one read an
    epoch."""
    victim = create_model("tiny", num_classes=10, device="cpu")
    attack = ADIL(victim, steps=500, n_atoms=6, batch_size=4, loss="logits",
                  cache=ArtifactCache(str(tmp_path)), model_name="tiny")
    images = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    profiling.reset()
    gate = Gate(victim, 2, lambda: attack.learn_dictionary((images, np.zeros(8, np.int64))))
    try:
        gate.wait()
        gate.epoch()  # the first epoch, in set-up
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                gate.epoch()
    finally:
        gate.stop()
    totals = profiling.totals()
    assert totals["adil/step"].count == 4 and totals["adil/epoch"].count == 2
    assert {name: t.count for name, t in totals.items() if name.startswith("sync/")} \
        == {"sync/read_later": 2}
    assert not any(s.seen for s in profiling.spans())  # none from the profiler's thread
    assert reader("host_syncs.learn")(ctx(2)) == 1
    own = sorted(s.self_ns / 1e6 for s in profiling.spans() if s.name == "adil/step")
    assert reader("host_step_ms.learn")(ctx(2)) == pytest.approx((own[1] + own[2]) / 2)
    profiling.reset()
