"""The yardstick's arithmetic: rates, the idle union, the byte formulas."""

import statistics

import pytest

import chip_smoke
from h100bench import arith


def test_rate_is_work_over_the_whole_window():
    assert arith.rate(6400, 32.0) == 200.0
    with pytest.raises(ValueError):
        arith.rate(1, 0.0)


@pytest.mark.parametrize("intervals, busy, gaps", [
    ([], 0.0, [(0.0, 10.0)]),
    ([(1, 3), (2, 5), (7, 8)], 5.0, [(0.0, 1), (5, 7), (8, 10.0)]),
    ([(-2, 1), (9, 12)], 2.0, [(1, 9)]),  # clipped to the window
    ([(0, 10), (3, 4)], 10.0, []),  # nested
    ([(4, 4), (11, 12)], 0.0, [(0.0, 10.0)]),  # empty and outside
])
def test_union_and_gaps(intervals, busy, gaps):
    assert arith.busy(intervals, 0.0, 10.0) == pytest.approx(busy)
    assert arith.gaps(intervals, 0.0, 10.0) == pytest.approx(gaps)
    assert busy + sum(e - s for s, e in arith.gaps(intervals, 0.0, 10.0)) == pytest.approx(10.0)


def test_idle_share_of_overlapping_streams():
    # Two streams overlap: the union counts the shared stretch once.
    busy = arith.busy([(0, 6), (4, 8)], 0, 10)
    assert busy == 8
    assert arith.idle_share(busy, 10) == pytest.approx(20.0)


@pytest.mark.parametrize("n, k, m", [(64, 100, 224 * 224 * 3), (128, 100, 224 * 224 * 3),
                                     (64, 10, 224 * 224 * 3), (4, 100, 32 * 32 * 3)])
def test_fused_perturb_bytes_match_chip_smoke(n, k, m):
    assert arith.fused_perturb_bytes(n, k, m) == chip_smoke.fused_perturb_bytes(n, k, m)
    ms, bound = chip_smoke.fused_perturb_bound_ms(n, k, m)
    assert bound == "bytes"
    assert arith.least_seconds(arith.fused_perturb_bytes(n, k, m)) * 1e3 == pytest.approx(ms)


@pytest.mark.parametrize("n", [100 * 224 * 224 * 3, 2000 * 100, 10 * 224 * 224 * 3])
def test_fused_adamw_project_bytes_match_chip_smoke(n):
    ms, bound = chip_smoke.fused_adamw_project_bound_ms(n)
    assert bound == "bytes"
    assert arith.least_seconds(arith.fused_adamw_project_bytes(n)) * 1e3 == pytest.approx(ms)


def test_peaks_match_chip_smoke():
    assert arith.PEAKS["hbm_bytes_per_s"] == chip_smoke.H100_BYTES_PER_S
    assert arith.peak_flop_per_s("float32") == chip_smoke.H100_FP32_FLOP_PER_S


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert arith.spread(values) == pytest.approx((q3 - q1) / med)
