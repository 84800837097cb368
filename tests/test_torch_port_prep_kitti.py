"""The port's KITTI prep (``deepi2p_tpu_torch/data/prep/kitti_prep.py``)
against the JAX package's on the pipeline of ``tests/test_data.py``
(``test_kitti_pipeline``): velodyne ``.bin`` -> (7, N) ``.npy`` with
normals, the camera-frame variant, poses -> ``.npz``, the offline
accumulation, and PNG -> ``.npy``.  Each case runs twice: the numpy route
on both sides (the JAX package's native library pinned off, the port's
``native=False``) and the native core the port builds loaded into both.
Points, intensities and poses are bitwise; normals within 1e-5 (each is
the eigenvector of the same covariance, its sign flipped to +z); the
image arrays bitwise ``cv2.imread``'s."""
import shutil

import cv2
import numpy as np
import pytest

import deepi2p_tpu.data.native as jax_native
from deepi2p_tpu.data.prep import kitti_prep as jax_prep
from deepi2p_tpu_torch.data import native as port_native
from deepi2p_tpu_torch.data.prep import kitti_prep
from torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture(params=["numpy", "native"])
def native(request, monkeypatch):
    monkeypatch.setattr(jax_native, "_LIB", None)
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "_TRIED", True)
        return False
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native core cannot be built")
    monkeypatch.setenv("DEEPI2P_NATIVE_LIB", str(port_native.build()))
    monkeypatch.setattr(jax_native, "_TRIED", False)
    assert jax_native.available()
    return True


def assert_same_cloud(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[0] == 7
    np.testing.assert_array_equal(got[:4], want[:4])
    np.testing.assert_allclose(got[4:], want[4:], atol=1e-5, rtol=0)
    assert np.all(got[6] >= -1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[4:7], axis=0), 1.0,
                               atol=1e-4)


def write_raw_tree(root, rng, n_frames=3, n_pts=900):
    """A raw odometry tree: velodyne ``.bin``, ``image_2`` PNGs, poses."""
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    (seq / "image_2").mkdir()
    for i in range(n_frames):
        raw = rng.normal(scale=10, size=(n_pts, 4)).astype(np.float32)
        raw.tofile(seq / "velodyne" / f"{i:06d}.bin")
        img = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
        assert cv2.imwrite(str(seq / "image_2" / f"{i:06d}.png"), img)
    poses = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).reshape(1, 12),
                    (n_frames, 1))
    poses[:, 3] = np.arange(n_frames)
    poses[:, 7] = 0.3 * np.arange(n_frames)
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "00.txt", poses)
    return seq


def test_prepare_frame_and_camera_frame(tmp_path, native):
    rng = np.random.default_rng(0)
    raw = rng.normal(scale=10, size=(800, 4)).astype(np.float32)
    bin_path = tmp_path / "000000.bin"
    raw.tofile(bin_path)
    for pkg, name in ((jax_prep, "jax"), (kitti_prep, "port")):
        kw = {} if pkg is jax_prep else dict(native=native)
        pkg.prepare_frame(str(bin_path), str(tmp_path / f"{name}.npy"),
                          voxel=0.5, **kw)
        K = np.array([[100.0, 0, 50], [0, 100, 40], [0, 0, 1]], np.float32)
        Pc = np.eye(4, dtype=np.float32)
        Pc[:3, 3] = (0.2, -0.1, 12.0)
        pkg.prepare_frame_in_img_frame(
            str(bin_path), str(tmp_path / f"{name}_img.npy"), Pc, K,
            (80, 100), voxel=0.5, **kw)
    assert_same_cloud(tmp_path / "port.npy", tmp_path / "jax.npy")
    assert_same_cloud(tmp_path / "port_img.npy", tmp_path / "jax_img.npy")


@pytest.mark.parametrize("k", [4, 16])
def test_estimate_normals(native, k):
    rng = np.random.default_rng(k)
    pc = rng.normal(scale=3, size=(500, 3)).astype(np.float32)
    want = jax_prep.estimate_normals(pc, k=k)
    got = kitti_prep.estimate_normals(pc, k=k, native=native)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_raw_tree_poses_and_accumulation(tmp_path, native):
    rng = np.random.default_rng(1)
    write_raw_tree(tmp_path / "raw", rng)
    for pkg, name in ((jax_prep, "jax"), (kitti_prep, "port")):
        kw = {} if pkg is jax_prep else dict(native=native)
        out = tmp_path / name
        assert pkg.prepare_kitti_velodyne(
            str(tmp_path / "raw"), str(out), [0], voxel=0.5, workers=2,
            **kw) == 3
        assert pkg.prepare_kitti_velodyne(
            str(tmp_path / "raw"), str(out), [0], voxel=0.5, **kw) == 0
        assert pkg.kitti_poses_to_npz(str(tmp_path / "raw" / "poses" /
                                          "00.txt"), str(out / "poses")) == 3
        assert pkg.accumulate_frames_offline(
            str(out / "sequences" / "00" / "voxel0.1-SNr0.6"),
            str(out / "poses"), str(out / "acc"), frame_num=1, skip=1,
            voxel=0.5, **kw) == 3
    for i in range(3):
        f = f"{i:06d}"
        assert_same_cloud(
            tmp_path / "port/sequences/00/voxel0.1-SNr0.6" / f"{f}.npy",
            tmp_path / "jax/sequences/00/voxel0.1-SNr0.6" / f"{f}.npy")
        got = np.load(tmp_path / "port/poses" / f"{f}.npz")["pose"]
        want = np.load(tmp_path / "jax/poses" / f"{f}.npz")["pose"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        a, b = (np.load(tmp_path / p / "acc" / f"{f}.npy")
                for p in ("port", "jax"))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:4], b[:4])
        np.testing.assert_allclose(a[4:], b[4:], atol=1e-5, rtol=0)


def test_png_to_npy_is_the_jax_packages(tmp_path):
    rng = np.random.default_rng(2)
    seq = write_raw_tree(tmp_path / "raw", rng, n_frames=2, n_pts=10)
    for pkg, name in ((jax_prep, "jax"), (kitti_prep, "port")):
        assert pkg.kitti_png_to_npy(str(tmp_path / "raw"),
                                    str(tmp_path / name), [0],
                                    workers=2) == 2
    for i in range(2):
        f = f"image_2/{i:06d}.npy"
        got = np.load(tmp_path / "port/sequences/00" / f)
        want = np.load(tmp_path / "jax/sequences/00" / f)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, cv2.imread(str(seq / f"image_2/{i:06d}.png"))[..., ::-1])
    assert kitti_prep.kitti_png_to_npy(str(tmp_path / "raw"),
                                       str(tmp_path / "port"), [0]) == 0
