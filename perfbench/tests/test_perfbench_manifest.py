"""BENCHMARK.json against the contract's shape and character rules, and
every file it names found by name."""

import json

import pytest

from perfbench.core import manifest

M = manifest.load()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(M) == TOP_KEYS
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(M["paths"]) <= 16
    assert all(manifest.valid_text(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_valid(section):
    names = [x["name"] for x in M[section]]
    assert len(names) == len(set(names))
    assert all(manifest.valid_name(n) for n in names), names


def test_metric_entries():
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.valid_unit(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert manifest.valid_text(m["layer"])
        assert manifest.metric_path(m["name"]).is_file()
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_configs_and_cells():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        assert manifest.valid_text(c["source"]) and manifest.valid_text(
            c["why"])
        assert len(c["reduced"]) <= 16
        assert all(manifest.valid_name(k) for k in c["reduced"])
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert all(k in conf for k in c["reduced"])
        assert "limits" in conf and "system" in conf
        assert (manifest.BENCH_DIR / "systems"
                / f"{conf['system']}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert manifest.valid_name(w["traffic"])
        assert manifest.valid_text(w["why"])
        assert manifest.traffic_path(w["traffic"]).is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    c = manifest.Cell(cell, M)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(manifest.load_reader(m["name"]))


def test_check_budget_fits():
    n = 24  # the most cells a later PR may bring
    runs = 2 + 14 * n
    need = runs * (M["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert need <= 43200
