"""The port stands alone: it imports without JAX, flax, orbax or the JAX
package, its entry points refuse to fall back to the CPU, and
``chip_smoke.py`` fails without a card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process itself holds both frameworks)
import torch

REPO = Path(__file__).resolve().parents[1]

ISOLATED = r'''
import importlib, pkgutil, sys
REFUSED = ("jax", "jaxlib", "flax", "orbax", "deepi2p_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import deepi2p_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deepi2p_tpu_torch.__path__,
                                               "deepi2p_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
assert len(names) >= 15, names
for new in ("ops.projection", "register.icp", "eval.dump", "eval.depth",
            "eval.harness", "eval.cli", "data.nuscenes"):
    assert "deepi2p_tpu_torch." + new in names, new

import tempfile
import numpy as np
import torch
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
from deepi2p_tpu_torch.eval.dump import save_sample_dump
from deepi2p_tpu_torch.eval.harness import evaluate_registration
from deepi2p_tpu_torch.models import build_detector
from deepi2p_tpu_torch.register.icp import icp_batch
dump_dir = tempfile.mkdtemp()
z = np.zeros(8)
save_sample_dump(dump_dir, "000000_00", pc=np.ones((8, 3)), coarse_pred=z,
                 coarse_label=z, fine_pred=z, fine_label=z, K=np.eye(3),
                 P=np.eye(4)[:3])
pts = np.ones((1, 8, 3), np.float32)
for call in (lambda: build_detector(config.tiny()),
             lambda: batch_to_torch(synthetic_batch(config.tiny())),
             lambda: evaluate_registration(dump_dir, H=8, W=8),
             lambda: icp_batch(pts, pts, torch.Generator())):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("an entry point ran without a card")
print("isolated ok", len(names))
'''


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    assert not torch.cuda.is_available()
    out = _run(["-c", ISOLATED], REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "isolated ok" in out.stdout


def test_chip_smoke_fails_without_a_card():
    out = _run([str(REPO / "chip_smoke.py")], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "phase=device start" in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
