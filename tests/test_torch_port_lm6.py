"""The port's 6-DoF LM (P=6) against the JAX package: the plain version
(the CUDA kernel's oracle, with the hand-derived Jacobian) against
``lm_solve_pallas(..., interpret=True)`` (Jacobian by ``jax.linearize``)
and against the autodiff ``frustum.lm_solve(is_2d=False)``.

Tolerances: at max_iter=1 only the order of the f32 sums over points and
the Jacobian's rounding differ: cost 1e-5 relative, theta 1e-4 absolute.
At max_iter=8 that is compounded over 8 accept/reject steps whose damping
adapts to the iterates: cost 1e-4 relative (theta is not compared there:
the 6-DoF cost is flat along some directions, so equal costs can sit at
thetas 1e-3 apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register import frustum as jf
from deepi2p_tpu.register.frustum_pallas import lm_solve_pallas
from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.register.frustum_cuda import lm_solve_plain

from test_torch_port_lm import H, T_LB, T_UB, W, problem


def problem6(seed, B, N, I, zero_angle=False):
    """test_torch_port_lm's problems with 6-DoF inits: the yaw as ry,
    small rx and rz (or all three angles 0: the first-order branch), the
    2-D translation inits, ty near 0."""
    rng = np.random.default_rng(seed)
    pts, lab, val, K, th4 = problem(rng, B=B, N=N, I=I)
    th6 = np.zeros((B, I, 6), np.float32)
    th6[..., 1] = th4[..., 0]
    th6[..., 3] = th4[..., 1]
    th6[..., 5] = th4[..., 3]
    th6[..., 0] = rng.normal(0, 0.05, (B, I))
    th6[..., 2] = rng.normal(0, 0.05, (B, I))
    th6[..., 4] = rng.normal(0, 0.05, (B, I))
    if zero_angle:
        th6[..., :3] = 0.0
    return pts, lab, val, K, th6


def run_plain(arrays, max_iter):
    th, c = lm_solve_plain(*(torch.from_numpy(a) for a in arrays), T_LB,
                           T_UB, H=H, W=W, max_iter=max_iter)
    return th.numpy(), c.numpy()


def run_jax_generic(arrays, max_iter):
    pts, lab, val, K, th = (jnp.asarray(a) for a in arrays)

    def one(t, p, l, v, k):
        return jf.lm_solve(p, l, v, k, t, jnp.asarray(T_LB),
                           jnp.asarray(T_UB), H=H, W=W, max_iter=max_iter,
                           is_2d=False)
    res = jax.vmap(jax.vmap(one, in_axes=(0, None, None, None, None)))(
        th, pts, lab, val, K)
    return np.asarray(res.theta), np.asarray(res.cost)


# N=1024 with zero angles: the first-order rotation branch without a
# padded tail (the Pallas kernel's zero-padded points differ otherwise)
@pytest.mark.parametrize("N,zero_angle", [(1024, False), (1024, True)])
@pytest.mark.parametrize("max_iter,rtol", [(1, 1e-5), (8, 1e-4)])
def test_lm6_plain_matches_pallas(N, zero_angle, max_iter, rtol):
    arrays = problem6(N + max_iter + zero_angle, B=2, N=N, I=8,
                      zero_angle=zero_angle)
    th_t, c_t = run_plain(arrays, max_iter)
    th_j, c_j = lm_solve_pallas(*(jnp.asarray(a) for a in arrays), T_LB,
                                T_UB, H=H, W=W, max_iter=max_iter,
                                interpret=True)
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=rtol, atol=0)
    if max_iter == 1:
        np.testing.assert_allclose(th_t, np.asarray(th_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("max_iter,rtol", [(1, 1e-5), (8, 1e-4)])
def test_lm6_plain_matches_jax_autodiff_lm(max_iter, rtol):
    arrays = problem6(7 + max_iter, B=2, N=1024, I=8)
    th_t, c_t = run_plain(arrays, max_iter)
    th_j, c_j = run_jax_generic(arrays, max_iter)
    np.testing.assert_allclose(c_t, c_j, rtol=rtol, atol=0)
    if max_iter == 1:
        np.testing.assert_allclose(th_t, th_j, rtol=0, atol=1e-4)


def test_sample_inits_and_pose_6dof():
    ang = torch.tensor([0.3, -1.0])
    th = tf.sample_inits(torch.Generator().manual_seed(0), ang, 16,
                         is_2d=False)
    assert tuple(th.shape) == (2, 16, 6)
    zero_cols = th[..., [0, 2, 3, 4]]
    assert bool((zero_cols == 0).all())
    assert bool((th[..., 5].abs() <= 10.0).all())
    aa = np.array([0.3, -1.2, 2.0, 0.5, -0.1, 3.0], np.float32)
    np.testing.assert_allclose(
        tf.theta_to_pose(torch.from_numpy(aa), is_2d=False).numpy(),
        np.asarray(jf.theta_to_pose(jnp.asarray(aa), False)), atol=1e-6)


@pytest.mark.parametrize("P", [4, 6])
@pytest.mark.parametrize("max_iter", [1, 8])
def test_lm_point_on_the_camera_plane(P, max_iter):
    """A point at exactly p2 = 0 (on the camera's z = 0 plane) at the
    clipped init, where 1/p2 = inf puts px, py at +-inf.  Labelled
    outside, its gated residual is 0 in the JAX package's kernel (its
    ``(xd + yd) * gate`` compiles to a select; inf * 0 would be NaN): the
    cost stays finite, and in the 6-DoF mode the init still moves.
    Labelled inside, the cost is inf and the normal matrix NaN, so no
    step is taken.  The solve's argmin agrees with ``jnp.argmin``."""
    if P == 6:
        pts, lab, val, K, th = problem6(41, B=1, N=1024, I=8,
                                        zero_angle=True)
    else:
        pts, lab, val, K, th = problem(np.random.default_rng(41), B=1,
                                       N=1024, I=8)
        th[..., 0] = 0.0
    # zero angles: R is exactly the identity, so p2 = z + tz
    tz = np.clip(th[0, :2, -1], T_LB[2], T_UB[2])
    pts[0, 0] = (1.5, 0.5, -tz[0])      # outside label, init 0
    pts[0, 1] = (-2.0, 0.3, -tz[1])     # inside label, init 1: inf cost
    lab[0, 0], lab[0, 1] = 0.0, 1.0
    val[0, :2] = 1.0
    arrays = (pts, lab, val, K, th)
    th_t, c_t = run_plain(arrays, max_iter)
    th_j, c_j = lm_solve_pallas(*(jnp.asarray(a) for a in arrays), T_LB,
                                T_UB, H=H, W=W, max_iter=max_iter,
                                interpret=True)
    c_j, th_j = np.asarray(c_j), np.asarray(th_j)
    assert np.isfinite(c_t[0, 0]) and np.isposinf(c_t[0, 1])
    np.testing.assert_array_equal(np.isfinite(c_t), np.isfinite(c_j))
    np.testing.assert_array_equal(np.isposinf(c_t), np.isposinf(c_j))
    np.testing.assert_array_equal(th_t[0, 1], th_j[0, 1])   # stuck init
    fin = np.isfinite(c_t)
    np.testing.assert_allclose(c_t[fin], c_j[fin],
                               rtol=1e-5 if max_iter == 1 else 1e-4, atol=0)
    if max_iter == 1:
        np.testing.assert_allclose(th_t, th_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        torch.argmin(torch.from_numpy(c_t), dim=1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(c_j), axis=1)))


def test_lm6_edge_crossing_matches_jax_autodiff_lm():
    """A problem on which the Pallas kernel parts from both the port and
    the JAX package's own autodiff LM: at 8 iterations one init's cost is
    1865.06 in ``lm_solve_pallas(interpret=True)`` and 1868.08 in the
    other two (0.16%), with thetas 2.4e-4 apart.  The outside residual
    ``xd + yd`` is cut to 0 where the gate closes (xd or yd reaches 0
    while the other is large), so the cost steps when a point crosses
    the frame's edge; f32 sums in another order move theta enough for one
    point to cross.  The port is held to the autodiff LM here, at the
    file's 8-iteration tolerance."""
    arrays = problem6(41, B=2, N=1024, I=8, zero_angle=True)
    _, c_t = run_plain(arrays, 8)
    _, c_j = run_jax_generic(arrays, 8)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=0)
