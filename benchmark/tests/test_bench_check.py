"""A run end to end on the CPU at small sizes: the result line, and the
output check coming out false with the control in the program's place and
with each fault planted under the timed path."""
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import faults, harness

from conftest import ROOT, small

SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
SEED = 2**31 + 12345


def run(cell, trace=False, wrapper=None, seconds=0.4):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            cfg_override=small, call_wrapper=wrapper)


def program_of(cell):
    return harness.load_module(
        "programs", harness.cell_spec(SPEC, cell)["config"]["name"])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    res, lines = run(cell, trace)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cs = harness.cell_spec(SPEC, cell)
    want = cs["per_layer"] if trace else cs["end_to_end"]
    for m in want:
        if m["name"] in line["metrics"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"]
    assert lines[-1].startswith("correct True")
    assert all(ln.startswith("check ") for ln in lines[:-1])


def control_in_place(cell):
    cs = harness.cell_spec(SPEC, cell)
    inputs = harness.load_module("configs", cs["config"]["name"])

    def wrap(call):
        def wrapped(state, record):
            # the control's outputs, from the record as the program got it
            return inputs.control(small(json.loads(
                (ROOT / cs["config"]["file"]).read_text())), record, "cpu")
        return wrapped
    return wrap


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    res, _ = run(cell, wrapper=control_in_place(cell))
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    wrap = {"stale": faults.stale, "altered": faults.altered,
            "half_batch": faults.half_batch(program_of(cell))}[fault]
    res, _ = run(cell, wrapper=wrap)
    assert res["correct"] is False and res["failed"] > 0


def test_without_a_card_the_command_prints_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if "no result" not in p.stderr:
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: the run stops at the program's import and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark import harness; "
            f"harness.run_cell({CELLS[0]!r}, 1, 0.1, False, device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "pyfft_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""
