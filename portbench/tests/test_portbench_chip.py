"""On the card: every cell of ``BENCHMARK.json`` at its own size runs
correct, and its control (the reference at the next lower precision in
the program's place) fails the cell's limits.  Skips without a CUDA
device."""
import json
import subprocess
import sys

import pytest

from portbench import run

CELLS = [w["name"] for w in
         run.load_json(run.CHECKOUT / "BENCHMARK.json")["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_its_control_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.calibrate", "--workload", cell,
         "--seeds", "424242", "--seconds", "3"], cwd=run.CHECKOUT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = run.load_json(run.HERE / "workloads" / f"{cell}.json")["limits"]
    assert line["correct"], line["readings"]["program"]
    control = line["readings"]["control"]
    assert any(control[k] > lim for k, lim in limits.items()), control
