"""chip_smoke.py's bounds: the least time an H100 SXM could take for each
kernel's work, which it prints beside the kernel's measured time."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel,shape,bytes_moved,bound_by", [
    # the serving shape: v, D, x read once and out written once
    ("fused_perturb", (64, 100, 224 * 224 * 3), 4 * (64 * 100 + 100 * 150528 + 2 * 64 * 150528),
     "bytes"),
    # K as wide as the rows and columns: the FMAs outweigh the bytes
    ("fused_perturb", (4096, 4096, 4096), None, "operations"),
    # the dictionary's size: p, g, mu, nu read and p, mu, nu written
    ("fused_adamw_project", (100 * 224 * 224 * 3,), 7 * 4 * 100 * 150528, "bytes"),
])
def test_bound_is_the_larger_of_bytes_and_operations(kernel, shape, bytes_moved, bound_by):
    smoke = _chip_smoke()
    ms, by = getattr(smoke, f"{kernel}_bound_ms")(*shape)
    assert by == bound_by
    if bound_by == "bytes":
        assert ms == pytest.approx(bytes_moved / 3.35e12 * 1e3, rel=1e-12)
    else:
        n, k, m = shape
        assert ms == pytest.approx(2 * n * k * m / 67e12 * 1e3, rel=1e-12)
    if kernel == "fused_perturb" and bound_by == "bytes":
        assert smoke.fused_perturb_bytes(*shape) == bytes_moved
        assert round(ms, 4) == 0.0410  # 137 MB at 3.35 TB/s


def test_fused_perturb_bound_at_the_generate_batch():
    # cli.generate's batch of 128: v, D, x and out are 214.4 MB, 0.0640 ms at
    # 3.35 TB/s; its 3.85 GFLOP of FMAs take 0.0575 ms at 67 TFLOP/s, so the
    # bytes still bound it.
    smoke = _chip_smoke()
    n, k, m = 128, 100, 224 * 224 * 3
    assert smoke.fused_perturb_bytes(n, k, m) == 4 * (n * k + k * m + 2 * n * m)
    ms, by = smoke.fused_perturb_bound_ms(n, k, m)
    assert by == "bytes" and round(ms, 4) == 0.0640
    assert 2 * n * k * m / 67e12 * 1e3 == pytest.approx(0.0575, abs=1e-4)
