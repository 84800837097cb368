"""The port stands alone: it imports without JAX, flax, orbax, optax or
the JAX package, its TensorBoard sink writes without TensorFlow, its
entry points refuse to fall back to the CPU, its KITTI loader runs
without OpenCV, and ``chip_smoke.py`` fails without a card."""
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
REFUSED = ("jax", "jaxlib", "flax", "orbax", "optax", "deepi2p_tpu")

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
import tempfile
from deepi2p_tpu_torch.utils.logging import MetricsLogger
log = MetricsLogger(tempfile.mkdtemp())
log.log_scalars("train", {"loss": 1.0}, 0)
log.close()
assert log._tb is not None and "tensorflow" not in sys.modules
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
assert len(names) >= 15, names
for new in ("ops.projection", "register.icp", "eval.dump", "eval.depth",
            "eval.harness", "eval.cli", "data.nuscenes", "train.checkpoint",
            "train.engine", "data.loader", "register.pnp", "train.loss",
            "train.cli", "train.classifier", "utils.logging", "ops.sampling",
            "data.augmentation", "data.base", "data.native", "data.kitti",
            "data.oxford", "data.nuscenes_tables"):
    assert "deepi2p_tpu_torch." + new in names, new

import tempfile
import numpy as np
import torch
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import (batch_to_torch, device_prefetch,
                                    synthetic_batch)
from deepi2p_tpu_torch.eval.dump import save_sample_dump
from deepi2p_tpu_torch.eval.harness import evaluate_registration
from deepi2p_tpu_torch.models import build_detector
from deepi2p_tpu_torch.register.icp import icp_batch
from deepi2p_tpu_torch.train.classifier import MMClassifier
from deepi2p_tpu_torch.train.cli import main as train_main
from deepi2p_tpu_torch.train.engine import Engine
dump_dir = tempfile.mkdtemp()
run_dir = tempfile.mkdtemp()
z = np.zeros(8)
save_sample_dump(dump_dir, "000000_00", pc=np.ones((8, 3)), coarse_pred=z,
                 coarse_label=z, fine_pred=z, fine_label=z, K=np.eye(3),
                 P=np.eye(4)[:3])
pts = np.ones((1, 8, 3), np.float32)
for call in (lambda: build_detector(config.tiny()),
             lambda: batch_to_torch(synthetic_batch(config.tiny())),
             lambda: evaluate_registration(dump_dir, H=8, W=8),
             lambda: icp_batch(pts, pts, torch.Generator()),
             lambda: Engine(config.tiny()),
             lambda: MMClassifier(config.tiny()),
             lambda: next(device_prefetch([{"x": np.zeros(2)}])),
             lambda: train_main(["--checkpoints-dir", run_dir + "/ck",
                                 "--log-dir", run_dir + "/log"])):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("an entry point ran without a card")
print("isolated ok", len(names))
'''


WITHOUT_CV2 = r'''
import sys, tempfile
from pathlib import Path
import numpy as np
sys.modules["cv2"] = None           # any import of cv2 raises ImportError
sys.path.insert(0, sys.argv[1])
from torch_port_data_trees import kitti_tree
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import BatchLoader, KittiLoader
from deepi2p_tpu_torch.data.base import load_image
root = kitti_tree(Path(tempfile.mkdtemp()) / "kitti",
                  np.random.default_rng(0), img_dtype=np.uint8)
cfg = config.tiny(input_pt_num=256, node_a_num=16, node_b_num=16,
                  accumulation_frame_num=1, accumulation_frame_skip=2,
                  delta_ij_max=5)
for mode in ("train", "val_random_Ry"):
    ld = KittiLoader(root, "val", cfg, seed=0, native=False)
    ld.mode = mode
    batch = next(iter(BatchLoader(ld, 4, num_workers=2)))
    assert batch["img"].shape == (4, cfg.img_H, cfg.img_W, 3), batch["img"].shape
try:
    load_image(str(Path(root) / "x.jpg"), cfg)
except RuntimeError as e:
    assert "OpenCV (cv2)" in str(e), e
else:
    raise SystemExit("a JPEG was read without cv2")
assert sys.modules["cv2"] is None
print("kitti without cv2 ok")
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


def test_kitti_loader_runs_without_opencv():
    out = _run(["-c", WITHOUT_CV2, str(REPO / "tests")], REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "kitti without cv2 ok" in out.stdout
