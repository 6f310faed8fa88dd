"""``BENCHMARK.json`` against the rules of its format, and every file a
cell, a configuration or a metric is found by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
END_TO_END = {"train_images_per_s", "attack_images_per_s", "peak_mem_gib", "setup_s"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"] == ["python3", "h100bench/run.py"]
    assert SPEC["paths"] == ["h100bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 << 10


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("h100bench/") and (ROOT / c["file"]).is_file()
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "h100bench" / "mixes" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "h100bench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert one_line(m["layer"]) and m["moves"] in END_TO_END
            assert (ROOT / "h100bench" / "metrics" / f"{m['name']}.py").is_file()
            moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m["name"] for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert any("mfu" in p for p in per)


def test_check_time_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
