"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name
in it resolves to a file of the harness."""
import json
import re

from portbench import run

BENCH = run.load_json(run.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and cells <= 24
    assert len(json.dumps(BENCH)) < 64 * 1024


def one_line(s, most=200):
    return 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_configs_and_cells_resolve():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        f = run.load_json(run.CHECKOUT / c["file"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert one_line(w["why"]) and w["chips"] == 1
        cell = run.load_json(run.HERE / "workloads" / f"{w['name']}.json")
        assert (cell["config"], cell["traffic"]["name"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        assert (run.HERE / "loops" / f"{cell['loop']}.py").is_file()
        assert cell["limits"]
        used.add(w["config"])
    assert used == names
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_resolve():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert run.metric_file(run.HERE, m["name"]).is_file()
    for m in BENCH["per_layer"]:
        assert one_line(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert e2e[m["moves"]] in run.cell_metrics(BENCH, c, False)
    for c in cells:
        reported = run.cell_metrics(BENCH, c, False)
        assert len(reported) >= 2
        assert run.cell_metrics(BENCH, c, True)
