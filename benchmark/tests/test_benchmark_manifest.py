"""BENCHMARK.json and the files it names: every piece is found by name, and
the manifest keeps the shape the benchmark's contract gives it."""

import json
import os
import re

import pytest

from benchmark.benchlib.manifest import BENCH_DIR, ROOT, Cell, load_module, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_found_by_name(name):
    cell = Cell(name, BENCH)
    assert hasattr(cell.driver(), "Driver")
    assert [m["name"] for m in cell.end_to_end][0] == "setup_s"
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    reported = {m["name"] for m in cell.end_to_end}
    for m, reader in zip(cell.per_layer, cell.readers()):
        assert m["moves"] in reported, (name, m["name"])
        assert callable(reader.read)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_every_reader_and_traffic_file_is_found():
    readers = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "metrics")) if f.endswith(".py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}
    traffic = {f[:-5] for f in os.listdir(os.path.join(BENCH_DIR, "traffic"))}
    assert traffic == {w["traffic"] for w in BENCH["workloads"]}
    for t in traffic:
        with open(os.path.join(BENCH_DIR, "traffic", f"{t}.json")) as f:
            load_module("drivers", json.load(f)["driver"])


def test_config_files_state_what_runs():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["stage_dims"] == [24, 48, 96, 192]
        assert cfg["stage_inner_dims"] == [54, 108, 216, 432]
        assert cfg["stage_depths"] == [5, 10, 25, 15] and cfg["image_size"] == 256
