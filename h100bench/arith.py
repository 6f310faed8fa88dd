"""The benchmark's yardstick arithmetic: peaks, bytes, rates, the idle union.

Pure Python, no torch: the CPU tests hold every formula here. The byte
counts follow the kernels' definitions (each input read once, each output
written once); they were first written in ``chip_smoke.py`` and are copied
here so that the benchmark keeps them whatever happens to that script.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

# One NVIDIA H100 SXM, dense rates, from NVIDIA's data sheet, at 700 W.
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "flop_per_s": {
        "float32": 67e12,  # outside the tensor cores
        "tf32": 495e12,
        "bfloat16": 989e12,
        "float16": 989e12,
    },
}

ADAMW_BYTES_PER_ELEMENT = 7 * 4  # read p, g, mu, nu; write p, mu, nu (fp32)


def fused_perturb_bytes(n: int, k: int, m: int) -> int:
    """Bytes one ``fused_perturb`` call must move: v (n, k), D (k, m) and
    x (n, m) read once, the adversary (n, m) written once, all fp32."""
    return 4 * (n * k + k * m + 2 * n * m)


def fused_adamw_project_bytes(n_elements: int) -> int:
    """Bytes one AdamW step and clamp over ``n_elements`` fp32 must move."""
    return ADAMW_BYTES_PER_ELEMENT * n_elements


def least_seconds(bytes_moved: float) -> float:
    """The least time the card's HBM needs for ``bytes_moved``."""
    return bytes_moved / PEAKS["hbm_bytes_per_s"]


def peak_flop_per_s(dtype: str) -> float:
    return PEAKS["flop_per_s"][dtype]


def rate(work: float, seconds: float) -> float:
    """Work over the whole window: never a median of chunks."""
    if seconds <= 0:
        raise ValueError(f"a window lasts more than 0 s, got {seconds}")
    return work / seconds


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """Each interval cut to [lo, hi]; those outside it dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside the window [lo, hi]."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The idle stretches of the window [lo, hi]: its complement of the
    union of ``intervals``, as (start, end) pairs."""
    out, at = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    """Percent of the window in which the device ran nothing."""
    return 100.0 * (1.0 - busy_s / window_s)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
