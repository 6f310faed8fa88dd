"""The reader of ``swin_window_attention_roofline`` on the CPU: Swin-B's
token-channels and the bytes of each direction against the hand counts,
the stages ``chip_smoke.py`` times (with the reader's count) against the
configuration, the share on a fixed device trace, and nothing read off the
card or from a trace without the kernel (a program without it).

    python -m pytest h100bench/tests -q -p no:cacheprovider   (from the root)
"""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

import chip_smoke
from h100bench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = "swin_window_attention_roofline"
CONFIG = json.loads((ROOT / "h100bench" / "configs" / "swin_b-fp32.json").read_text())


def reader_module():
    spec = importlib.util.spec_from_file_location("roofline_reader",
                                                  ROOT / "h100bench" / "metrics" / f"{NAME}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_swin_b_token_channels_and_bytes_are_the_hand_counts():
    m = reader_module()
    # 56² x 128 x 2 + 28² x 256 x 2 + 14² x 512 x 18 + 7² x 1024 x 2
    tc = m.token_channels(CONFIG)
    assert tc == 802_816 + 401_408 + 1_806_336 + 100_352 == 3_110_912
    assert m.FORWARD_BYTES * tc == 49_774_592  # 49.8 MB an image
    assert m.BACKWARD_BYTES * tc == 87_105_536  # 87.1 MB an image


def test_both_directions_are_bound_by_bytes_and_a_pass_is_2_6_ms_at_b64():
    m = reader_module()
    tc = m.token_channels(CONFIG)
    for nbytes, flop in ((m.FORWARD_BYTES, m.FORWARD_FLOP), (m.BACKWARD_BYTES, m.BACKWARD_FLOP)):
        assert m.direction_seconds(tc, 49, nbytes, flop) == pytest.approx(nbytes * tc / 3.35e12)
    least = m.least_seconds(CONFIG, [(64, True)])
    assert least == pytest.approx(64 * 44 * 3_110_912 / 3.35e12)
    assert round(least * 1e3, 1) == 2.6
    assert m.least_seconds(CONFIG, [(64, False)]) == pytest.approx(64 * 16 * 3_110_912 / 3.35e12)


def test_chip_smokes_stages_are_the_configurations():
    m = reader_module()
    stages = chip_smoke.SWIN_B_STAGES
    assert [heads for _, _, heads, _ in stages] == CONFIG["num_heads"]
    assert [blocks for _, _, _, blocks in stages] == CONFIG["depths"]
    assert sum(blocks * side * side * c for side, c, _, blocks in stages) == m.token_channels(CONFIG)
    # The stages' bounds, as chip_smoke sums them, make up the reader's pass.
    pass_s = sum(blocks * m.pass_seconds(64 * side * side * c, 49, True)
                 for side, c, _, blocks in stages)
    assert m.least_seconds(CONFIG, [(64, True)]) == pytest.approx(pass_s)


def context(kernel_s, on_device=True, passes=((64, False),) + ((64, True),) * 30):
    return SimpleNamespace(config=CONFIG, passes=list(passes), on_device=on_device,
                           trace=SimpleNamespace(kernel_s=kernel_s))


def test_the_share_on_a_fixed_trace_and_nothing_without_the_kernel():
    read = harness.load_metric(harness.BENCH_DIR, NAME)
    m = reader_module()
    kernels = {"void (anonymous namespace)::swin_window_attention_forward_kernel<7, 32>(...)": 0.2,
               "void (anonymous namespace)::swin_window_attention_backward_kernel<7, 32>(...)": 0.3,
               "ampere_sgemm_128x64_nn": 5.0}
    passes = [(64, False)] + [(64, True)] * 30
    want = 100.0 * m.least_seconds(CONFIG, passes) / 0.5
    assert read(context(kernels)) == pytest.approx(want)
    assert read(context({"ampere_sgemm_128x64_nn": 5.0})) is None  # the parent's trace
    assert read(context(kernels, on_device=False)) is None
    assert read(context(kernels, passes=())) is None
