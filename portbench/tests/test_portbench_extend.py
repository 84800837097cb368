"""A configuration, a cell and a per-layer metric added as new files are
found by name, with no edit to a file the benchmark has."""
import json
import shutil

from portbench import run
from portbench.tests import tiny

METRIC = '''"""Batches of the window."""


def read(rec):
    return float(len(rec.batches))
'''


def test_new_files_alone_add_a_cell(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(run.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "kitti.json").read_text())
    cfg.update(tiny.CONFIG)
    cfg.update(name="kitti_wide", img_W=256)
    (root / "configs" / "kitti_wide.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "kitti.icp.json").read_text())
    cell.update(config="kitti_wide")
    cell["traffic"].update(tiny.TRAFFIC["kitti.icp"], name="icp.b2")
    (root / "workloads" / "kitti_wide.icp.json").write_text(json.dumps(cell))
    (root / "metrics" / "batches.count.py").write_text(METRIC)

    bench = run.load_json(run.CHECKOUT / "BENCHMARK.json")
    bench["workloads"].append({"name": "kitti_wide.icp",
                               "config": "kitti_wide", "traffic": "icp.b2",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("kitti_wide.icp")
    bench["per_layer"].append({
        "name": "batches.count", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "device",
        "moves": "pairs_per_s", "workloads": ["kitti_wide.icp"]})
    result, _ = run.run_cell("kitti_wide.icp", 7, 0.2, True, device="cpu",
                             bench=bench, root=root)
    assert result["correct"]
    assert result["metrics"]["batches.count"]["value"] >= 1
    assert result["device"]["count"] == 1
    for p, data in before.items():
        assert p.read_bytes() == data, p
