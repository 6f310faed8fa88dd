"""The reader of ``xcit_xca_roofline`` on the CPU: XCiT-L12's token-channels
and the bytes of each direction against the hand counts, a b64 pass's
least time (1.518 ms both ways), the shape ``chip_smoke.py`` times (with
the reader's count) against the configuration, the share on a fixed
device trace, and nothing read off the card or from a trace without the
kernel (a program without it, as the parent of the kernel's change).

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
NAME = "xcit_xca_roofline"
CONFIG = json.loads((ROOT / "h100bench" / "configs" / "xcit_l12-fp32.json").read_text())


def reader_module():
    spec = importlib.util.spec_from_file_location("xca_roofline_reader",
                                                  ROOT / "h100bench" / "metrics" / f"{NAME}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_xcit_l12_token_channels_and_bytes_are_the_hand_counts():
    m = reader_module()
    nc = m.token_channels(CONFIG)
    assert nc == 196 * 768 * 12 == 1_806_336
    assert m.head_dim(CONFIG) == 48
    assert m.FORWARD_BYTES * nc == 28_901_376  # 28.9 MB an image
    assert m.BACKWARD_BYTES * nc == 50_577_408  # 50.6 MB an image


def test_both_directions_are_bound_by_bytes_and_a_pass_is_1_518_ms_at_b64():
    m = reader_module()
    nc = m.token_channels(CONFIG)
    for nbytes, flop in ((m.FORWARD_BYTES, m.FORWARD_FLOP), (m.BACKWARD_BYTES, m.BACKWARD_FLOP)):
        assert m.direction_seconds(nc, 48, nbytes, flop) == pytest.approx(nbytes * nc / 3.35e12)
        assert flop * 48 * nc / 67e12 < nbytes * nc / 3.35e12
    least = m.least_seconds(CONFIG, [(64, True)])
    assert least == pytest.approx(64 * 44 * 1_806_336 / 3.35e12)
    assert round(least * 1e3, 3) == 1.518
    assert m.least_seconds(CONFIG, [(64, False)]) == pytest.approx(64 * 16 * 1_806_336 / 3.35e12)


def test_chip_smokes_xca_shape_is_the_configurations():
    m = reader_module()
    tokens, heads, d, blocks = chip_smoke.XCIT_L12_XCA
    assert (heads, d, blocks) == (CONFIG["num_heads"], m.head_dim(CONFIG), CONFIG["depth"])
    assert tokens * heads * d * blocks == m.token_channels(CONFIG)
    assert chip_smoke.XCIT_TEMPERATURE == CONFIG["weights"]["temperature"]
    # A block's bound, as chip_smoke counts it, 12 times is the reader's pass.
    assert blocks * m.pass_seconds(64 * tokens * heads * d, d, True) == pytest.approx(
        m.least_seconds(CONFIG, [(64, True)]))


def context(kernel_s, on_device=True, passes=((64, False),) + ((64, True),) * 30):
    return SimpleNamespace(config=CONFIG, passes=list(passes), on_device=on_device,
                           trace=SimpleNamespace(kernel_s=kernel_s))


def test_the_share_on_a_fixed_trace_and_nothing_without_the_kernel():
    read = harness.load_metric(harness.BENCH_DIR, NAME)
    m = reader_module()
    kernels = {"void (anonymous namespace)::xcit_xca_forward_kernel<48>(float const*, ...)": 0.2,
               "void (anonymous namespace)::xcit_xca_backward_kernel<48>(float const*, ...)": 0.4,
               "ampere_sgemm_128x64_nn": 5.0}
    passes = [(64, False)] + [(64, True)] * 30
    want = 100.0 * m.least_seconds(CONFIG, passes) / 0.6
    assert read(context(kernels)) == pytest.approx(want)
    parent = {"ampere_sgemm_128x64_nn": 5.0, "void at::native::elementwise_kernel<128, 2>": 1.7}
    assert read(context(parent)) is None
    assert read(context(kernels, on_device=False)) is None
    assert read(context(kernels, passes=())) is None
