"""The port's host-side sampling (``deepi2p_tpu_torch/ops/sampling.py``)
against the JAX package's numpy functions on seeded inputs: every output
bitwise and the generator at the same next draw.  The voxel average sums
with ``np.bincount`` where the JAX function uses ``np.add.at``; both sum
in float64 in input order, so the result is the same bits."""
import numpy as np
import pytest

from deepi2p_tpu.ops import sampling as jax_sampling
from deepi2p_tpu_torch.ops import sampling


def cloud(seed, n, extra=0):
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(n, 3)) * [20.0, 20.0, 2.0]).astype(np.float32)
    ex = rng.normal(size=(n, extra)).astype(np.float32) if extra else None
    return pc, ex


@pytest.mark.parametrize("n,voxel,extra", [(500, 5.0, 0), (60000, 0.3, 4),
                                           (60000, 0.1, 1), (3000, 2.0, 7)])
def test_voxel_downsample_bitwise(n, voxel, extra):
    pc, ex = cloud(n + extra, n, extra)
    want = jax_sampling.voxel_downsample_np(pc, voxel, ex)
    got = sampling.voxel_downsample_np(pc, voxel, ex)
    if ex is None:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] < n


def test_voxel_downsample_float64_points_bitwise():
    pc, ex = cloud(9, 4000, 2)
    pc, ex = pc.astype(np.float64) * 1.37, ex.astype(np.float64)
    for w, g in zip(jax_sampling.voxel_downsample_np(pc, 0.7, ex),
                    sampling.voxel_downsample_np(pc, 0.7, ex)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dim", [2, 3])
def test_farthest_point_sample_matches_jax(dim):
    pts = np.random.default_rng(dim).normal(size=(700, dim)).astype(
        np.float32)
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    want = jax_sampling.farthest_point_sample_np(pts, 32, a)
    got = sampling.farthest_point_sample_np(pts, 32, b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert a.random() == b.random()


@pytest.mark.parametrize("have,want_n", [(1000, 256), (100, 256), (256, 256)])
def test_random_resample_matches_jax(have, want_n):
    a, b = np.random.default_rng(have), np.random.default_rng(have)
    np.testing.assert_array_equal(
        sampling.random_resample_np(have, want_n, b),
        jax_sampling.random_resample_np(have, want_n, a))
    assert a.random() == b.random()


def test_projective_and_approximate_fps_match_jax():
    pc, _ = cloud(4, 2000)
    pc[:, 2] = np.abs(pc[:, 2]) + 5.0
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for w, g in zip(jax_sampling.projective_farthest_sample_np(pc, 24, K, a),
                    sampling.projective_farthest_sample_np(pc, 24, K, b)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        sampling.fps_approximate_np(pc, 4.0, 300, b),
        jax_sampling.fps_approximate_np(pc, 4.0, 300, a))
    assert a.random() == b.random()
