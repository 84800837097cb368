"""Each cell end to end on the CPU at tiny sizes with the plain versions
of the kernels: a result line of the contract's shape, and correct."""
import json

import pytest

from portbench import run
from portbench.tests.tiny import CELLS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs(cell, trace):
    result, checks = run_tiny(cell, trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["checks"]) == set(checks)
    bench = run.load_json(run.CHECKOUT / "BENCHMARK.json")
    names = {m["name"] for m in run.cell_metrics(bench, cell, trace)}
    assert set(line["metrics"]) <= names
    if not trace:
        # every end-to-end metric is read from the host clock
        assert set(line["metrics"]) == names
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert "breakdown" in line and "window_s" in line["device"]
    for m in line["metrics"].values():
        assert m["value"] == m["value"]          # not NaN
