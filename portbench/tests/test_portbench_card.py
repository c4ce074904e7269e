"""On the card: one short run of each cell from a checkout's root, and the
control at the cell's own size. Marked ``card``; they skip without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          cell, "--seed", "2147483653", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.control",
                          "--workload", cell, "--seeds", "1,2,3"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert all(json.loads(line)["correct"] is False
               for line in out.stdout.strip().splitlines())
