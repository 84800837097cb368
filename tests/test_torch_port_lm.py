"""The port's LM solve (plain version, the CUDA kernel's oracle) against
the JAX package's ``lm_solve_pallas`` in interpret mode, same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register.frustum_pallas import lm_solve_pallas
from deepi2p_tpu_torch.register.frustum_cuda import (lm_solve, lm_solve_cuda,
                                                     lm_solve_plain)

H, W = 160, 512
K_NP = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]],
                np.float32)
T_LB = (-5.0, -0.1, -10.0)
T_UB = (5.0, 0.1, 10.0)


def problem(rng, B, N, I):
    """Ring clouds seen from a random yaw/translation, labels from the
    true projection, inits scattered around the truth (tz never 0)."""
    pts, labs, th0 = [], [], []
    for _ in range(B):
        yaw = rng.uniform(-np.pi, np.pi)
        t = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-3, 3)])
        ang = rng.uniform(0, 2 * np.pi, N)
        r = rng.uniform(5, 40, N)
        pc = np.stack([r * np.cos(ang), rng.uniform(-2, 2, N),
                       r * np.sin(ang)], -1).astype(np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        cam = pc @ R.T + t
        z = cam[:, 2]
        px = K_NP[0, 0] * cam[:, 0] / z + K_NP[0, 2]
        py = K_NP[1, 1] * cam[:, 1] / z + K_NP[1, 2]
        lab = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
               & (z > 0.1)).astype(np.float32)
        # 5% label noise, as a classifier would give
        flip = rng.random(N) < 0.05
        lab[flip] = 1.0 - lab[flip]
        th = np.stack([yaw + rng.normal(0, 0.3, I),
                       rng.normal(0, 1.0, I), np.zeros(I),
                       t[2] + rng.uniform(0.5, 3.0, I)
                       * rng.choice([-1, 1], I)], -1)
        pts.append(pc)
        labs.append(lab)
        th0.append(th.astype(np.float32))
    valid = (rng.random((B, N)) < 0.95).astype(np.float32)
    return (np.stack(pts), np.stack(labs), valid,
            np.tile(K_NP, (B, 1, 1)), np.stack(th0))


def run_both(arrays, max_iter):
    th_t, c_t = lm_solve_plain(*(torch.from_numpy(a) for a in arrays),
                               T_LB, T_UB, H=H, W=W, max_iter=max_iter)
    th_j, c_j = lm_solve_pallas(*(jnp.asarray(a) for a in arrays), T_LB,
                                T_UB, H=H, W=W, max_iter=max_iter,
                                interpret=True)
    return th_t.numpy(), c_t.numpy(), np.asarray(th_j), np.asarray(c_j)


# max_iter=1: one sweep at theta0, one solve, one sweep at the proposal —
# only the order of the sums over points differs (f32), so 1e-5 relative.
# max_iter=8: the same, compounded over 8 accept/reject steps whose
# damping adapts to the iterates, so 1e-4 relative.
@pytest.mark.parametrize("N", [1024, 2048])
@pytest.mark.parametrize("I", [8, 16])
@pytest.mark.parametrize("max_iter,rtol", [(1, 1e-5), (8, 1e-4)])
def test_lm_plain_matches_pallas(N, I, max_iter, rtol):
    rng = np.random.default_rng(N + I + max_iter)
    arrays = problem(rng, B=2, N=N, I=I)
    th_t, c_t, th_j, c_j = run_both(arrays, max_iter)
    np.testing.assert_allclose(c_t, c_j, rtol=rtol, atol=0)
    np.testing.assert_allclose(th_t, th_j, rtol=rtol, atol=10 * rtol)


def test_lm_max_iter_zero_is_clipped_init():
    rng = np.random.default_rng(5)
    pts, lab, val, K, th0 = problem(rng, B=1, N=1024, I=8)
    th0[0, 0, 1] = 9.0                  # outside the tx bound
    th_t, c_t, th_j, c_j = run_both((pts, lab, val, K, th0), 0)
    assert th_t[0, 0, 1] == 5.0
    np.testing.assert_allclose(th_t, th_j, rtol=0, atol=0)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)


def test_lm_p6_is_not_ported():
    """The 6-DoF mode (P=6) is ported now (its parity tests are in
    test_torch_port_lm6.py): on the CPU it runs the plain version and
    keeps the shapes; any other P is refused."""
    rng = np.random.default_rng(0)
    pts, lab, val, K, _ = problem(rng, B=1, N=1024, I=8)
    th6 = torch.zeros(1, 8, 6)
    th6[..., 5] = 2.0
    args = [torch.from_numpy(a) for a in (pts, lab, val, K)]
    theta, cost = lm_solve(*args, th6, T_LB, T_UB, H=H, W=W, max_iter=1)
    assert tuple(theta.shape) == (1, 8, 6) and tuple(cost.shape) == (1, 8)
    assert bool(torch.isfinite(cost).all())
    with pytest.raises(ValueError, match="P=6"):
        lm_solve(*args, torch.zeros(1, 8, 5), T_LB, T_UB, H=H, W=W,
                 max_iter=1)


def test_lm_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in problem(rng, B=1, N=1024, I=8)]
    with pytest.raises(ValueError, match="CUDA"):
        lm_solve_cuda(*args, T_LB, T_UB, H=H, W=W, max_iter=1)
