"""The port's data and utils modules: ArrayDataset draws the JAX package's
batch order, the CPU prefetch passes batches straight through, and the
timer and the metric log behave as the JAX package's do."""

import numpy as np
import pytest
import torch

from dl_attack_on_imagenet_tpu.data import ArrayDataset as JaxArrayDataset
from dl_attack_on_imagenet_tpu.utils import MetricLogger as JaxMetricLogger
from dl_attack_on_imagenet_tpu_torch.data import ArrayDataset, as_array_dataset, prefetch_to_device
from dl_attack_on_imagenet_tpu_torch.utils import MetricLogger, StepTimer, annotate


def _arrays(n=11):
    rs = np.random.RandomState(0)
    return rs.uniform(0, 1, (n, 4, 4, 3)).astype(np.float32), rs.randint(0, 10, n)


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=5), dict(shuffle=True, seed=6),
                                dict(shuffle=True, seed=5, drop_remainder=True)])
def test_batches_follow_the_jax_order(kw):
    images, labels = _arrays()
    got = list(ArrayDataset(images, labels).batches(4, **kw))
    want = list(JaxArrayDataset(images, labels).batches(4, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_as_array_dataset_and_checks():
    images, labels = _arrays()
    ds = as_array_dataset((images, labels))
    assert as_array_dataset(ds) is ds and len(ds) == 11 and ds.image_shape == (4, 4, 3)
    holder = type("Holder", (), {"images": images, "labels": labels})()
    np.testing.assert_array_equal(as_array_dataset(holder).labels, labels)
    np.testing.assert_array_equal(ds.subset([2, 3]).images, images[2:4])
    with pytest.raises(ValueError):
        ArrayDataset(images, labels[:3])
    with pytest.raises(TypeError):
        as_array_dataset(42)


def test_prefetch_on_the_cpu_passes_batches_through():
    images, labels = _arrays()
    host = [(images[i:i + 3], labels[i:i + 3]) for i in range(0, 11, 3)]
    got = list(prefetch_to_device(iter(host), size=2, device="cpu"))
    assert len(got) == len(host)
    for (x, y), (hx, hy) in zip(got, host):
        assert x.device.type == "cpu" and not x.is_pinned()
        np.testing.assert_array_equal(x.numpy(), hx)
        np.testing.assert_array_equal(y.numpy(), hy)


def test_step_timer_leaves_out_the_warmup():
    timer = StepTimer(warmup=1)
    assert timer.summary()["steps"] == 0
    for _ in range(3):
        with timer.step(), annotate("test/step"):
            pass
    timer.record(0.5)
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["max_s"] == 0.5
    assert summary["steps_per_sec"] == pytest.approx(1 / timer.mean)


def test_metric_log_writes_what_the_jax_logger_writes(tmp_path):
    port, jax_log = MetricLogger(str(tmp_path / "a" / "m.jsonl")), JaxMetricLogger(str(tmp_path / "b.jsonl"))
    for log in (port, jax_log):
        log.log(0, loss=np.float32(0.5), note="x")
        log.log(1, loss=torch.tensor(0.25), fooling=1)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"} for r in rows]
    assert strip(port.read()) == strip(jax_log.read()) == [
        {"step": 0, "loss": 0.5, "note": "x"}, {"step": 1, "loss": 0.25, "fooling": 1.0}]
    MetricLogger(None).log(0, loss=1.0)  # no path: a no-op
    assert MetricLogger(None).read() == []
