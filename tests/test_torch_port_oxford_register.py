"""The benchmark's Oxford registration cell (``oxford.register-b128``: the
detector's eval forward, the argmax and ``solve_frustum_batch``) end to end
on the CPU, at sizes of its own with the published widths: correct, no
failed pair, and only the metrics ``BENCHMARK.json`` names for the cell."""
import json
import time

import pytest
import torch

from portbench import run

CELL = "oxford.register-b128"
CONFIG = {"input_pt_num": 512, "node_a_num": 16, "node_b_num": 16,
          "k_ab": 4, "img_H": 64, "img_W": 128}
TRAFFIC = {"batch": 2, "pool": 2, "profile_batches": 1}
SEED = 2 ** 31 + 20           # over 32 signed bits
BENCH = run.load_json(run.CHECKOUT / "BENCHMARK.json")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_cell_runs_correct_on_the_cpu(trace):
    result, checks = run.run_cell(
        CELL, SEED, 0.3, trace, device="cpu", bench=BENCH,
        overrides={"config": CONFIG, "traffic": TRAFFIC},
        t0=time.monotonic())
    line = json.loads(json.dumps(result))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= TRAFFIC["batch"]
    assert set(line["checks"]) == set(checks) == {
        "coarse_logit_gap", "fine_logit_gap", "solve_excess_median",
        "pose_cost_gap"}
    names = {m["name"] for m in run.cell_metrics(BENCH, CELL, trace)}
    assert set(line["metrics"]) <= names
    if trace:
        # device times are the card's: on the CPU only the host clock's
        # and the counted ones are read
        assert {"frustum_probe_ms", "frustum_refine_ms"} <= names
        assert "mfu_pct.register" in line["metrics"]
    else:
        assert set(line["metrics"]) == names == {"pairs_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] == m["value"]          # not NaN


def test_every_metric_of_the_cell_has_a_reader():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["config"] == "oxford"
    cell = run.load_json(run.HERE / "workloads" / f"{CELL}.json")
    assert cell["traffic"]["batch"] == 128 and cell["chips"] == 1
    metrics = (run.cell_metrics(BENCH, CELL, False)
               + run.cell_metrics(BENCH, CELL, True))
    assert {m["name"] for m in metrics} >= {
        "pairs_per_s", "setup_s", "forward_ms", "solve_ms", "knn_roofline",
        "lm_roofline", "idle_pct.register", "mfu_pct.register",
        "frustum_probe_ms", "frustum_refine_ms"}
    for m in metrics:
        assert run.metric_file(run.HERE, m["name"]).is_file(), m["name"]
