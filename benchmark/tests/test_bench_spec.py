"""BENCHMARK.json against the benchmark's contract, and every name in it
found in its file."""
import json
import re

import pytest

from benchmark import harness, traffic

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names += [w["name"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in (SPEC["configs"], SPEC["workloads"],
                  SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    cs = harness.cell_spec(SPEC, cell)
    cfg = json.loads((ROOT / cs["config"]["file"]).read_text())
    assert cfg["name"] == cs["config"]["name"]
    assert set(cfg["limits"]) and all(v >= 0 for v in cfg["limits"].values())
    inputs = harness.load_module("configs", cfg["name"])
    for fn in ("make_record", "reference", "control", "compare", "samples",
               "work_counts"):
        assert callable(getattr(inputs, fn))
    program = harness.load_module("programs", cfg["name"])
    for fn in ("prepare", "call", "half_batch"):
        assert callable(getattr(program, fn))
    traffic.load(cs["cell"]["traffic"])
    reported = {m["name"] for m in cs["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cs["per_layer"]
    for m in cs["end_to_end"] + cs["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    spec = SPEC
    cells = {w["name"] for w in spec["workloads"]}
    configs = {w["config"] for w in spec["workloads"]}
    assert configs == {c["name"] for c in spec["configs"]}
    for m in spec["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            cs = harness.cell_spec(spec, cell)
            assert m["moves"] in {e["name"] for e in cs["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_file_under_the_benchmark_is_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_traffic_files_hold_parameters_only():
    for p in (ROOT / "benchmark" / "traffic").glob("*.json"):
        mix = traffic.load(p.stem)
        assert set(mix) == set(traffic.KEYS)
