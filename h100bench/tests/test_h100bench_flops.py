"""The FLOP counts each configuration stores, recounted on the plain
reference at a small batch and scaled to one image."""

import json

import pytest

from h100bench import count_flops


@pytest.mark.parametrize("name", ["resnet50-fp32", "vit_b16-fp32"])
def test_stored_flops_per_image(name):
    with open(count_flops.BENCH_DIR / "configs" / f"{name}.json") as f:
        config = json.load(f)
    assert count_flops.count(config, batch=1) == config["flops_per_image"]
