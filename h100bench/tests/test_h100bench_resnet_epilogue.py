"""The reader of ``resnet_epilogue_roofline.learn`` and ``.attack`` on the
CPU: ResNet-50's post-convolution elements and each direction's bytes
against the hand counts, ResNet-18's by the same rule, the share on a fixed
device trace, and nothing read off the card or from a trace without the
kernel (a program without it).

    python -m pytest h100bench/tests -q -p no:cacheprovider   (from the root)
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from h100bench import harness
from h100bench.metrics import resnet_epilogue_roofline as m

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "h100bench" / "configs" / "resnet50-fp32.json").read_text())


def test_resnet50_elements_and_bytes_are_the_hand_counts():
    inner, outputs = m.site_elements(CONFIG)
    # The stem's 64 x 112², and each block's 1x1 and 3x3 maps a stage:
    # 3 x 2 x 64 x 56²; 128 x 56² + 7 x 128 x 28²; 256 x 28² + 11 x 256 x 14²;
    # 512 x 14² + 5 x 512 x 7².
    assert inner == 802_816 + 1_204_224 + 1_103_872 + 752_640 + 225_792 == 4_089_344
    # 3 x 256 x 56² + 4 x 512 x 28² + 6 x 1024 x 14² + 3 x 2048 x 7²
    assert outputs == 2_408_448 + 1_605_632 + 1_204_224 + 301_056 == 5_519_360
    assert m.image_bytes(CONFIG) == (98_947_072, 115_304_448)
    assert 1e3 * m.pass_seconds(CONFIG, 64, False) == pytest.approx(1.8903, abs=1e-4)
    assert 1e3 * (m.pass_seconds(CONFIG, 64, True)
                  - m.pass_seconds(CONFIG, 64, False)) == pytest.approx(2.2028, abs=1e-4)


def test_resnet18_by_the_same_rule():
    config = dict(CONFIG, stage_sizes=[2, 2, 2, 2], expansion=1)
    # The stem, then each block's first convolution; 2 x 64 x 56² + ... outputs.
    assert m.site_elements(config) == (802_816 + 752_640, 752_640)


def context(kernel_s, on_device=True, passes=((64, False),) + ((64, True),) * 30):
    return SimpleNamespace(config=CONFIG, passes=list(passes), on_device=on_device,
                           trace=SimpleNamespace(kernel_s=kernel_s))


@pytest.mark.parametrize("name", ["resnet_epilogue_roofline.learn",
                                  "resnet_epilogue_roofline.attack"])
def test_the_share_on_a_fixed_trace_and_nothing_without_the_kernel(name):
    read = harness.load_metric(harness.BENCH_DIR, name)
    kernels = {"void (anonymous namespace)::resnet_epilogue_forward_kernel<1>(...)": 0.2,
               "void (anonymous namespace)::resnet_epilogue_backward_kernel<0>(...)": 0.3,
               "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs": 5.0}
    passes = [(64, False)] + [(64, True)] * 30
    least = 64 * (31 * 98_947_072 + 30 * 115_304_448) / 3.35e12
    assert read(context(kernels)) == pytest.approx(100.0 * least / 0.5)
    parent = {"void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(...)": 1.6,
              "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs": 5.0}
    assert read(context(parent)) is None
    assert read(context(kernels, on_device=False)) is None
    assert read(context(kernels, passes=())) is None
    assert read(context(kernels, passes=passes)) == read(context(kernels))
