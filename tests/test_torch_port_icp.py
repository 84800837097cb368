"""The port's ICP (``register/icp.py``, plain 1-NN on the CPU) against the
JAX package's, on the same inputs.

The JAX side of the ICP comparison runs its 1-NN through
``nn1_pallas(interpret=True)`` (as on the TPU; on the CPU it would take
the ``|x|^2+|y|^2-2xy`` XLA path), patched in with ``pytest.MonkeyPatch``.
``icp_point_to_point`` is jit-cached, so these tests use shapes no other
test traces.  Tolerances are stated per test."""
import functools

import jax  # noqa: F401  (port tests hold both frameworks)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.ops import knn_pallas as jax_knn_pallas
from deepi2p_tpu.register import icp as ji
from deepi2p_tpu.register.frustum import rodrigues
from deepi2p_tpu.register.metrics import pose_diff_np
from deepi2p_tpu_torch.ops.knn_cuda import nn1_cuda
from deepi2p_tpu_torch.register import icp as ti


def _rigid_problem(rng, N, ry_max=0.15, t_max=1.0):
    src = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    ry = rng.uniform(-ry_max, ry_max)
    t = np.array([rng.uniform(-t_max, t_max), 0.0,
                  rng.uniform(-t_max, t_max)], np.float32)
    c, s = np.cos(ry), np.sin(ry)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = R
    P[:3, 3] = t
    return src, src @ R.T + t, P


def test_depth_to_pointcloud_and_scale_match_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(2, 30, (24, 40)).astype(np.float32)
    K = np.array([[30.0, 0, 20], [0, 30.0, 12], [0, 0, 1]], np.float32)
    for stride in (1, 4):
        pc_t = ti.depth_to_pointcloud(torch.from_numpy(depth),
                                      torch.from_numpy(K), stride=stride)
        pc_j = ji.depth_to_pointcloud(jnp.asarray(depth), jnp.asarray(K),
                                      stride=stride)
        np.testing.assert_allclose(pc_t.numpy(), np.asarray(pc_j),
                                   rtol=1e-6, atol=1e-6)
    z, m, pz = (rng.uniform(1, 9, 50).astype(np.float32),
                (rng.random(50) < 0.5).astype(np.int32),
                rng.uniform(1, 9, 30).astype(np.float32))
    s_t = ti.calibrate_depth_scale(*(torch.from_numpy(a) for a in (z, m, pz)))
    s_j = ji.calibrate_depth_scale(*(jnp.asarray(a) for a in (z, m, pz)))
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)


def test_kabsch_matches_jax_batched():
    """Weighted Kabsch on 4 problems at once (the port batches it):
    R and t within 1e-5 absolute of the JAX package's, one at a time."""
    rng = np.random.default_rng(1)
    src = rng.normal(size=(4, 64, 3)).astype(np.float32) * 5
    dst = src + rng.normal(size=(4, 64, 3)).astype(np.float32) * 0.1
    dst[:, :, 0] += 1.0
    w = (rng.random((4, 64)) < 0.8).astype(np.float32)
    R_t, t_t = ti._kabsch(*(torch.from_numpy(a) for a in (src, dst, w)))
    for b in range(4):
        R_j, t_j = ji._kabsch(jnp.asarray(src[b]), jnp.asarray(dst[b]),
                              jnp.asarray(w[b]))
        np.testing.assert_allclose(R_t[b].numpy(), np.asarray(R_j),
                                   atol=1e-5)
        np.testing.assert_allclose(t_t[b].numpy(), np.asarray(t_j),
                                   atol=1e-5)


@pytest.mark.parametrize("coarse", [None, 8.0])
def test_thr_schedule_matches_jax(coarse):
    np.testing.assert_allclose(
        ti._thr_schedule(1.0, coarse, 30).numpy(),
        np.asarray(ji._thr_schedule(1.0, coarse, 30)), rtol=1e-6)


def test_flatten_2d_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(3):
        aa = rng.normal(size=3).astype(np.float32)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = np.asarray(rodrigues(jnp.asarray(aa)))
        P[:3, 3] = rng.normal(size=3)
        np.testing.assert_allclose(
            ti.flatten_2d(torch.from_numpy(P)).numpy(),
            np.asarray(ji.flatten_2d(jnp.asarray(P))), atol=1e-6)


@pytest.mark.parametrize("coarse", [None, 6.0])
def test_icp_point_to_point_matches_jax(coarse):
    """Same source, target and P_init: the pose within 1e-4 absolute and
    the same inlier count behind the fitness (the iterates differ only by
    f32 rounding; no correspondence flip showed on these inputs; the two
    f32 means of the same 0/1 flags round apart by an ulp)."""
    rng = np.random.default_rng(3)
    src, tgt, _ = _rigid_problem(rng, 333)
    tgt = tgt[:301]                       # a target of another size
    P0 = np.eye(4, dtype=np.float32)
    P0[0, 3] = 0.7
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_knn_pallas, "pallas_eligible_nn1", lambda q, db: True)
        mp.setattr(jax_knn_pallas, "nn1_pallas", functools.partial(
            jax_knn_pallas.nn1_pallas, interpret=True))
        rj = ji.icp_point_to_point(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.asarray(P0), max_iter=12,
                                   coarse_threshold=coarse)
        P_j, fit_j = np.asarray(rj.P), float(rj.fitness)
    rt = ti.icp_point_to_point(torch.from_numpy(src), torch.from_numpy(tgt),
                               torch.from_numpy(P0), max_iter=12,
                               coarse_threshold=coarse)
    np.testing.assert_allclose(rt.P.numpy(), P_j, rtol=0, atol=1e-4)
    assert round(float(rt.fitness) * 333) == round(fit_j * 333)


def test_icp_batch_padded_targets():
    """The JAX package's recovery test (test_register_extra.py:167-197) on
    the port: padded targets, every pair within 0.5 m and 5 deg."""
    rng = np.random.default_rng(4)
    B, N = 3, 256
    probs = [_rigid_problem(rng, N) for _ in range(B)]
    target = np.full((B, N + 64, 3), 1e6, np.float32)
    for b, (_, tgt, _) in enumerate(probs):
        target[b, :N] = tgt
    res = ti.icp_batch(np.stack([p[0] for p in probs]), target,
                       torch.Generator().manual_seed(0), n_inits=16,
                       max_iter=25, t_amplitude=(1.5, 0.0, 1.5),
                       ry_amplitude=0.2, device="cpu")
    assert tuple(res.P.shape) == (B, 4, 4) and tuple(res.fitness.shape) == (B,)
    for b in range(B):
        rte, rre = pose_diff_np(res.P[b].double().numpy(), probs[b][2])
        assert rte < 0.5 and rre < 5.0, (b, rte, rre)
        assert float(res.fitness[b]) > 0.5


def test_icp_batch_seeded_inits():
    """P_seed: a seed near a far pose lets the batch solve a problem its
    blind draws miss (the JAX package's test_register_extra.py:224-248)."""
    rng = np.random.default_rng(5)
    N = 192
    src = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    ry, t = 2.4, np.array([4.0, 0.0, -6.0], np.float32)
    c, s = np.cos(ry), np.sin(ry)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    tgt = (src @ R.T + t)[None]
    P_want = np.eye(4, dtype=np.float32)
    P_want[:3, :3] = R
    P_want[:3, 3] = t
    seed_P = P_want.copy()
    seed_P[:3, 3] += [0.5, 0.0, -0.4]
    kw = dict(n_inits=8, max_iter=25, device="cpu")
    blind = ti.icp_batch(src[None], tgt, torch.Generator().manual_seed(3),
                         **kw)
    seeded = ti.icp_batch(src[None], tgt, torch.Generator().manual_seed(3),
                          P_seed=seed_P[None], **kw)
    rte_b, _ = pose_diff_np(blind.P[0].double().numpy(), P_want)
    rte_s, rre_s = pose_diff_np(seeded.P[0].double().numpy(), P_want)
    assert rte_s < 0.5 and rre_s < 5.0, (rte_s, rre_s)
    assert rte_s < rte_b


def test_seeded_inits_start_at_the_seed():
    rng = np.random.default_rng(6)
    P_seed = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    P_seed[:, :3, 3] = rng.normal(size=(2, 3))
    P = ti._seeded_inits(torch.Generator().manual_seed(0), 5,
                         torch.from_numpy(P_seed))
    assert tuple(P.shape) == (2, 5, 4, 4)
    np.testing.assert_allclose(P[:, 0].numpy(), P_seed, atol=1e-6)
    R = P[..., :3, :3]
    np.testing.assert_allclose((R @ R.mT).numpy(),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def test_icp_runs_one_nn1_call_per_iteration(monkeypatch):
    """All pairs x inits share one 1-NN call per iteration (and one for the
    final fitness): on the card that is one kernel launch each."""
    calls = []
    real = ti.nn1

    def counted(q, db):
        calls.append((tuple(q.shape), tuple(db.shape)))
        return real(q, db)
    monkeypatch.setattr(ti, "nn1", counted)
    rng = np.random.default_rng(7)
    src, tgt, _ = _rigid_problem(rng, 64)
    ti.icp_batch(np.stack([src, src]), np.stack([tgt, tgt]),
                 torch.Generator().manual_seed(0), n_inits=12, max_iter=5,
                 device="cpu")
    assert calls == [((2 * 16, 64, 3), (2, 64, 3))] * 6


def test_icp_batch_defaults_to_the_card():
    rng = np.random.default_rng(8)
    src, tgt, _ = _rigid_problem(rng, 32)
    nn1_cuda.launches = 0
    with pytest.raises(RuntimeError, match="CUDA"):
        ti.icp_batch(src[None], tgt[None], torch.Generator())
    assert nn1_cuda.launches == 0
