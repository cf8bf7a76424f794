"""Each cell run on the card through the command, a short window: the
result is correct and names the card.  Skips without a card."""
import json
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT

CELLS = [c["name"] for c in harness.load_spec()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", str(2**31 + 7), "--seconds", "2",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
