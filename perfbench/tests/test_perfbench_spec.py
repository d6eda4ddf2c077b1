"""``BENCHMARK.json`` against the contract it is written to, and every file
it names found by name."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import faults, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return harness.spec()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(spec):
    assert set(spec) == TOP_KEYS
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)


def test_command_and_paths(spec):
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()


def test_names_units_and_lines(spec):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in spec[g]]
        assert len(names) == len(set(names)), g
        assert all(NAME.match(n) for n in names), g
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metric_entries(spec):
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert "setup_s" in e2e_names
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e_names
        assert set(m["workloads"]) <= cells
        moved = next(e for e in spec["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)


def test_four_chip_cells_at_most_a_quarter_or_one(spec):
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)


def test_every_cell_reports_setup_another_e2e_and_a_layer(spec):
    for w in spec["workloads"]:
        cell = harness.Cell.load(w["name"])
        e2e = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.metrics(True), w["name"]


def test_every_file_is_found_by_name(spec):
    for c in spec["configs"]:
        path = harness.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("perfbench/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
    assert len({c["file"] for c in spec["configs"]}) == len(spec["configs"])
    used = set()
    for w in spec["workloads"]:
        cell = harness.Cell.load(w["name"])
        used.add(w["config"])
        assert hasattr(harness.load_module("drivers",
                                           cell.workload["driver"]),
                       "Driver")
        assert "sample" in cell.traffic and "trace_seconds" in cell.traffic
        assert cell.workload["test_sizes"], w["name"]
        assert cell.workload["driver"] in faults.FAULTS, w["name"]
    assert used == {c["name"] for c in spec["configs"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_files_under_paths_are_named_from_name_characters(spec):
    for p in spec["paths"]:
        for f in (harness.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or ".cache" in f.parts:
                continue
            rel = f.relative_to(harness.ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_cell_not_in_benchmark_json_has_its_files(spec):
    """A workload file that ``BENCHMARK.json`` does not list yet (its cell
    waits for a later benchmark PR) names files that are all there, and
    its cell loads only from an entry handed to it."""
    listed = {w["name"] for w in spec["workloads"]}
    for path in (harness.HERE / "workloads").glob("*.json"):
        workload = json.loads(path.read_text())
        assert set(workload) <= {"config", "traffic", "driver", "ranks",
                                 "test_sizes"}, path.stem
        assert (harness.HERE / "configs" / f"{workload['config']}.json"
                ).is_file()
        assert (harness.HERE / "traffic" / f"{workload['traffic']}.json"
                ).is_file()
        assert hasattr(harness.load_module("drivers", workload["driver"]),
                       "Driver")
        assert workload["driver"] in faults.FAULTS, path.stem
        if path.stem not in listed:
            with pytest.raises(KeyError):
                harness.Cell.load(path.stem)
