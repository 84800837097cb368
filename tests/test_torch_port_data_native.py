"""The native data core as the port builds and binds it
(``deepi2p_tpu_torch/data/native.py``) against numpy: FPS picks distinct
points, each the farthest from those before it, and one seed gives one
answer; the voxel average keeps the numpy version's centroid and, on a
grid anchored at the cloud's minimum instead of at 0, about its voxel
count; kNN is exact.  The build lands in the port's build directory, never in
``native/``."""
import shutil

import numpy as np
import pytest

from deepi2p_tpu_torch._build import BUILD_DIR
from deepi2p_tpu_torch.data import native
from deepi2p_tpu_torch.ops.sampling import voxel_downsample_np


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native core cannot be built")
    path = native.build()
    assert path.parent == BUILD_DIR and path.exists()
    assert native.available()
    return path


def test_fps_property_and_seed(lib):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    idx = native.fps(pts, 64, seed=3)
    assert idx.dtype == np.int64 and len(set(idx.tolist())) == 64
    np.testing.assert_array_equal(native.fps(pts, 64, seed=3), idx)
    # greedy FPS: each pick is the farthest from those before it
    sel = pts[idx]
    for j in range(1, 64):
        d = np.min(np.sum((pts[:, None] - sel[None, :j]) ** 2, -1), axis=1)
        assert np.isclose(d[idx[j]], d.max(), rtol=1e-6)
    assert not np.array_equal(native.fps(pts, 64, seed=4), idx)


def test_voxel_downsample_against_numpy(lib):
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(20000, 3)) * 5).astype(np.float32)
    ex = rng.uniform(size=(20000, 4)).astype(np.float32)
    got_p, got_e = native.voxel_downsample(pts, 0.5, ex)
    want_p, want_e = voxel_downsample_np(pts, 0.5, ex)
    assert got_e.shape == (got_p.shape[0], 4)
    assert abs(got_p.shape[0] - want_p.shape[0]) <= 0.02 * want_p.shape[0]
    # every voxel's mean lies inside its voxel: points within 0.5 * sqrt(3)
    # of their nearest output point
    nn = native.knn(pts, got_p, 1)[:, 0]
    assert np.linalg.norm(pts - got_p[nn], axis=1).max() <= 0.5 * 3 ** 0.5
    np.testing.assert_allclose(got_p.mean(0), want_p.mean(0), atol=0.05)
    np.testing.assert_allclose(got_e.mean(0), want_e.mean(0), atol=0.01)


def test_knn_exact(lib):
    rng = np.random.default_rng(2)
    db = rng.normal(size=(6000, 3)).astype(np.float32)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    got = native.knn(q, db, 8)
    d = np.sum((q[:, None] - db[None]) ** 2, -1)
    np.testing.assert_array_equal(got, np.argsort(d, axis=1,
                                                  kind="stable")[:, :8])


def test_bad_shapes_raise(lib):
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError):
        native.fps(pts, 11)
    with pytest.raises(ValueError):
        native.knn(np.zeros((4, 2), np.float32), pts, 1)
