"""Nothing a benchmark run loads is JAX or the JAX package (top-level
names compared whole: ``deepi2p_tpu_torch`` is not ``deepi2p_tpu``), and
the plain reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(run.__file__).resolve().parent
REFERENCE_BANNED = {"deepi2p_tpu_torch", *run.FORBIDDEN}

DRY_RUN = """
import importlib, json, sys, torch
torch.set_num_threads(2)
from pathlib import Path
from portbench import run
from portbench.tests.tiny import CELLS, run_tiny
for path in sorted(Path(run.HERE).rglob("*.py")):
    rel = path.relative_to(run.CHECKOUT).with_suffix("")
    if "tests" in rel.parts:
        continue
    if "." in rel.name:         # a metric named with dots: loaded by file
        run.load_module(path)
    else:
        importlib.import_module(".".join(rel.parts))
for cell in CELLS:
    run_tiny(cell, trace=True)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_dry_run_of_every_cell_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=run.CHECKOUT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "deepi2p_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_source_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not imported_names(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    files = list((HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        assert not imported_names(path) & REFERENCE_BANNED, path
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, portbench.reference.detector, "
         "portbench.reference.frustum, portbench.reference.icp; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=run.CHECKOUT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    for name in REFERENCE_BANNED:
        assert f"'{name}'" not in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepi2p_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deepi2p_tpu.config", sys)
    assert run.forbidden_modules() == ["deepi2p_tpu"]
