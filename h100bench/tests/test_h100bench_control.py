"""On the card: each cell's check passes the program and fails its
control, the plain reference in TF32 (the step below the configurations'
fp32) in the program's place, at the cell's own size, on one seed.

    python -m pytest h100bench/tests/test_h100bench_control.py -q

(from the checkout's root; elsewhere these tests skip).
"""

import json
import tempfile
from pathlib import Path

import pytest
import torch

from h100bench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cuda():
    """The card; skips where there is none (decided when a test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda, cell):
    limits = harness.load_cell(ROOT, cell).limits
    with tempfile.TemporaryDirectory(dir=harness.workdir_root(ROOT)) as workdir:
        row = calibrate.readings(ROOT, cell, 2**31 + 4099, True, cuda, workdir)
    program_ok, program = harness.judge(row["program"], limits)
    control_ok, control = harness.judge(row["control"], limits)
    assert program_ok, program
    assert not control_ok, control
