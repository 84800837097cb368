"""The port stands alone: it imports without JAX, flax, orbax, optax,
the JAX package, OpenCV, matplotlib or PIL, its TensorBoard sink writes
without TensorFlow, its debug images and dump overlays are written in
that process, its KITTI prep and Oxford traversal build run there (PNGs
read, JPEGs written by the port's own code), its
entry points refuse to fall back to the CPU, its KITTI and Oxford loaders
run without OpenCV (JPEGs through the port's own decoder), its native
build reads only the port's sources, and ``chip_smoke.py`` fails without
a card."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process itself holds both frameworks)
import torch

REPO = Path(__file__).resolve().parents[1]

ISOLATED = r'''
import importlib, pkgutil, sys
REFUSED = ("jax", "jaxlib", "flax", "orbax", "optax", "deepi2p_tpu",
           "cv2", "matplotlib", "PIL")

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
            "data.oxford", "data.nuscenes_tables", "data.jpeg",
            "models.depth", "train.depth_cli", "data.synthetic_device",
            "register.frustum_fast", "register.noise", "utils.png",
            "utils.vis", "eval.debug_vis", "ops.ball_query", "ops.som",
            "models.extra_layers", "train.aux_losses", "utils.profiling",
            "data.prep.kitti_prep", "data.prep.nuscenes_prep",
            "data.prep.oxford_image", "data.prep.oxford_prep",
            "parallel.collectives", "parallel.mesh",
            "parallel.registration", "parallel.dryrun"):
    assert "deepi2p_tpu_torch." + new in names, new

import os, tempfile
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
                                 "--log-dir", run_dir + "/log"]),
             lambda: train_main(["--device-data", "--checkpoints-dir",
                                 run_dir + "/ck", "--log-dir",
                                 run_dir + "/log"]),
             lambda: __import__("deepi2p_tpu_torch.eval.debug_vis",
                                fromlist=["x"]).debug_report(
                 dump_dir, "000000_00", H=8, W=8, out_dir=run_dir)):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("an entry point ran without a card")

# the debug report and the dump's overlays, end to end, on the CPU
from deepi2p_tpu_torch.data.jpeg import read_png
from deepi2p_tpu_torch.eval.debug_vis import debug_report
from deepi2p_tpu_torch.eval.dump import dump_predictions
cfg = config.tiny()
viz_dir, dump2 = tempfile.mkdtemp(), tempfile.mkdtemp()
dump_predictions(build_detector(cfg, device="cpu", seed=0),
                 [synthetic_batch(cfg, seed=0)], cfg, dump2,
                 viz_dir=viz_dir, save_images=True)
rep = debug_report(dump2, "000000_00", H=cfg.img_H, W=cfg.img_W,
                   out_dir=viz_dir, n_steps=4, device="cpu")
assert set(rep) == {"prefix", "final_cost", "rte", "rre"}, rep
for f in ("000000_00_img.png", "000000_00_prediction.png",
          "000001_00_prediction.png", "000000_00_trace.png",
          "000000_00_scene.png", "000000_00_overlay.png"):
    assert read_png(os.path.join(viz_dir, f)).ndim == 3, f
# the offline prep on small raw trees: KITTI velodyne, PNGs and poses;
# an Oxford traversal of Bayer PNGs with a LUT, written as JPEGs
from deepi2p_tpu_torch.data.prep import kitti_prep, oxford_prep
from deepi2p_tpu_torch.utils.png import encode_png
from pathlib import Path
rng = np.random.default_rng(0)
raw = Path(tempfile.mkdtemp())
seq = raw / "sequences" / "00"
for sub in ("velodyne", "image_2"):
    (seq / sub).mkdir(parents=True)
for i in range(2):
    rng.normal(scale=10, size=(500, 4)).astype(np.float32).tofile(
        seq / "velodyne" / f"{i:06d}.bin")
    (seq / "image_2" / f"{i:06d}.png").write_bytes(encode_png(
        rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)))
out = raw / "out"
assert kitti_prep.prepare_kitti_velodyne(str(raw), str(out), [0],
                                         voxel=0.5) == 2
assert kitti_prep.kitti_png_to_npy(str(raw), str(out), [0]) == 2
np.savetxt(raw / "00.txt", np.tile(np.eye(3, 4).reshape(1, 12), (2, 1)))
assert kitti_prep.kitti_poses_to_npz(str(raw / "00.txt"),
                                     str(out / "poses")) == 2
assert np.load(out / "sequences/00/voxel0.1-SNr0.6/000001.npy").shape[0] == 7
trav, us = "2015-01-01-00-00-00", 1_000_000
t = raw / "ox" / trav
for sub in ("vo", "stereo/centre"):
    (t / sub).mkdir(parents=True)
lms = raw / "lms" / trav / "lms_front"
lms.mkdir(parents=True)
with open(t / "vo" / "vo.csv", "w") as f:
    f.write("source,destination,x,y,z,roll,pitch,yaw\n")
    for i in range(1, 41):
        f.write(f"{i * us // 10},{(i - 1) * us // 10},1.0,0,0,0,0,0\n")
cam_ts = [i * us // 10 for i in range(41)]
(t / "stereo" / "stereo.timestamps").write_text(
    "".join(f"{ts} 1\n" for ts in cam_ts))
for ts in cam_ts:
    (t / "stereo" / "centre" / f"{ts}.png").write_bytes(encode_png(
        rng.integers(0, 256, (16, 24), dtype=np.uint8)))
lms_ts = [i * us // 50 for i in range(201)]
(raw / "lms" / trav / "lms_front.timestamps").write_text(
    "".join(f"{ts} 1\n" for ts in lms_ts))
for ts in lms_ts:
    np.stack([rng.uniform(-2, 0.5, 40), rng.uniform(-10, 10, 40),
              rng.uniform(0, 255, 40)], 1).tofile(lms / f"{ts}.bin")
u, v = np.meshgrid(np.arange(24.0) + 0.3, np.arange(16.0) - 0.2)
np.stack([u.ravel(), v.ravel()]).tofile(raw / "lut.bin")
ext = raw / "extrinsics"
ext.mkdir()
for name in ("stereo", "lms_front"):
    (ext / f"{name}.txt").write_text("0 0 0 0 0 0\n")
sdk = oxford_prep.sdk_from_extrinsics(str(ext), lut_path=str(raw / "lut.bin"))
summary = oxford_prep.build_traversal(
    trav, str(raw / "lms"), str(raw / "ox"), str(raw / "oxout"), sdk,
    pc_sample_distance=2.0, accumulation_distance=10.0,
    ignore_first_n_second=0.5)
assert summary["n_pc"] > 0 and summary["n_img"] > 30, summary
from deepi2p_tpu_torch.data.jpeg import decode
jpg = sorted((raw / "oxout" / trav / "stereo" / "centre").iterdir())[0]
assert decode(jpg).shape == (16, 24, 3)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("isolated ok", len(names))
'''


WITHOUT_CV2 = r'''
import hashlib, json, sys, tempfile
from pathlib import Path
import numpy as np
sys.modules["cv2"] = None           # any import of cv2 raises ImportError
sys.path.insert(0, sys.argv[1])
from torch_port_data_trees import kitti_tree, oxford_tree
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import BatchLoader, KittiLoader, OxfordLoader
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
# a committed JPEG decodes to its cv2 digest, at the Oxford preset's half
# size, and the Oxford loader reads a tree of such files
fixtures = Path(sys.argv[1]) / "data" / "torch_port_jpeg"
name = "oxford_1280x960_420_q95.jpg"
h, w, digest = json.loads((fixtures / "digests.json").read_text())[name]["2"]
img, pre_scaled = load_image(str(fixtures / name), config.oxford())
assert pre_scaled and img.shape == (h, w, 3)
assert hashlib.sha256(img.tobytes()).hexdigest() == digest
root = oxford_tree(Path(tempfile.mkdtemp()) / "oxford",
                   np.random.default_rng(0),
                   jpeg=(fixtures / name).read_bytes())
cfg = config.tiny(input_pt_num=256, node_a_num=16, node_b_num=16)
for mode in ("train", "val_random_Ry"):
    batch = next(iter(BatchLoader(OxfordLoader(root, mode, cfg, seed=0),
                                  4, num_workers=2)))
    assert batch["img"].shape == (4, cfg.img_H, cfg.img_W, 3), batch["img"].shape
assert sys.modules["cv2"] is None
print("kitti and oxford without cv2 ok")
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
    assert "kitti and oxford without cv2 ok" in out.stdout


ALONE = r'''
import sys
from pathlib import Path
from deepi2p_tpu_torch.data import jpeg, native
lib = native.build()
assert Path(sys.argv[1]) in lib.parents, lib
img = jpeg.decode(sys.argv[2], 2)
assert jpeg.decode(jpeg.encode_jpeg(img)).shape == img.shape
print(img.shape)
'''


def test_builds_read_only_the_ports_sources(tmp_path):
    """Both builds (the CUDA kernels, the native host core) compile
    sources inside ``deepi2p_tpu_torch/`` that include no file by a quoted
    path, and the package copied alone builds its host core and decodes a
    JPEG."""
    from deepi2p_tpu_torch import _build
    from deepi2p_tpu_torch.data import native
    srcs = [*_build.sources(), *native.SOURCES]
    assert {p.name for p in srcs} >= {"knn.cu", "nn1.cu", "frustum_lm.cu",
                                      "deepi2p_data.cpp", "jpeg.cpp",
                                      "jpeg_encode.cpp"}
    for src in srcs:
        assert _build.PKG_DIR in src.resolve().parents, src
        assert not re.search(r'#\s*include\s*"', src.read_text()), src
    compiles, link = _build.nvcc_commands("nvcc", _build.sources(),
                                          tmp_path / "lib.so")
    for cmd in compiles:
        assert _build.PKG_DIR in Path(cmd[-1]).resolve().parents, cmd
    if shutil.which("g++") is None:
        return
    shutil.copytree(_build.PKG_DIR, tmp_path / "deepi2p_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    fixture = REPO / "tests" / "data" / "torch_port_jpeg" / "s444_q85.jpg"
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", ALONE,
                          str(tmp_path / "deepi2p_tpu_torch"), str(fixture)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "(120, 160, 3)"
