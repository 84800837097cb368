"""The port's ``solve_frustum_batch`` against the JAX package's halving
policy with the same ``theta0``, and its geometry helpers and metrics.

On the CPU the JAX ``solve_frustum_batch`` takes its ``frustum_fast``
branch, whose keep rule differs from the Pallas branch the port follows;
the JAX side here is therefore the Pallas branch composed from
``lm_solve_pallas(interpret=True)`` calls (``frustum.py:439-477``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register import frustum as jf
from deepi2p_tpu.register import metrics as jm
from deepi2p_tpu.register.frustum_pallas import lm_solve_pallas
from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.register import metrics as tm

from test_torch_port_lm import H, K_NP, T_LB, T_UB, W, problem


def jax_halving_solve(pc, pred, K, theta0, *, max_iter, solver_stride,
                      is_2d=True):
    """frustum.py's Pallas branch, with lm_solve_pallas in interpret mode."""
    _, valid = jax.vmap(jf.initial_guess)(pc, pred)
    s = solver_stride
    ps = max(1, 4 // s)
    pc_s, lab_s, val_s = (pc[:, ::s], pred.astype(pc.dtype)[:, ::s],
                          valid[:, ::s])
    I = theta0.shape[1]
    probe_iter = min(8, max_iter)
    kw = dict(H=H, W=W, interpret=True)
    thetas, costs = lm_solve_pallas(pc_s[:, ::ps], lab_s[:, ::ps],
                                    val_s[:, ::ps], K, theta0, T_LB, T_UB,
                                    max_iter=probe_iter, **kw)
    keep = max((I // 8) // 8 * 8, 8)
    top = jnp.argsort(costs, axis=1)[:, :keep]
    theta_top = jnp.take_along_axis(thetas, top[:, :, None], axis=1)
    thetas, costs = lm_solve_pallas(pc_s, lab_s, val_s, K, theta_top, T_LB,
                                    T_UB, max_iter=max_iter - probe_iter,
                                    **kw)
    best = jnp.argmin(costs, axis=1)
    th = jnp.take_along_axis(thetas, best[:, None, None], axis=1)[:, 0]
    cost = jnp.take_along_axis(costs, best[:, None], axis=1)[:, 0]
    P = jax.vmap(lambda t: jf.theta_to_pose(t, is_2d))(th)
    has = jnp.sum(pred, axis=1) > 0
    P = jnp.where(has[:, None, None], P, jnp.eye(4))
    return P, jnp.where(has, cost, 1e4)


@pytest.fixture(scope="module")
def solved():
    rng = np.random.default_rng(11)
    pts, lab, _, K, _ = problem(rng, B=2, N=4096, I=8)
    pred = lab.astype(np.int32)
    pred[1] = 0                          # a pair with no inside points
    ang, _ = jax.vmap(jf.initial_guess)(jnp.asarray(pts), jnp.asarray(pred))
    theta0 = np.array(jax.vmap(lambda k, a: jf.sample_inits(k, a, 64))(
        jax.random.split(jax.random.PRNGKey(0), 2), ang))
    kw = dict(max_iter=12, solver_stride=2)
    P_j, c_j = jax_halving_solve(jnp.asarray(pts), jnp.asarray(pred),
                                 jnp.asarray(K), jnp.asarray(theta0), **kw)
    P_t, c_t = tf.solve_frustum_batch(
        torch.from_numpy(pts), torch.from_numpy(pred), torch.from_numpy(K),
        H=H, W=W, theta0=torch.from_numpy(theta0), n_inits=64, **kw)
    return np.asarray(P_j), np.asarray(c_j), P_t.numpy(), c_t.numpy()


def test_solve_matches_jax_halving(solved):
    P_j, c_j, P_t, c_t = solved
    np.testing.assert_allclose(c_t[0], c_j[0], rtol=1e-4)
    np.testing.assert_allclose(P_t[0], P_j[0], rtol=0, atol=1e-3)


def test_solve_no_inside_points_gives_identity(solved):
    P_j, c_j, P_t, c_t = solved
    np.testing.assert_array_equal(P_t[1], np.eye(4, dtype=np.float32))
    assert c_t[1] == 1e4
    np.testing.assert_array_equal(P_t[1], P_j[1])
    assert c_j[1] == c_t[1]


def test_solve_draws_inits_from_generator():
    rng = np.random.default_rng(2)
    pts, lab, _, K, _ = problem(rng, B=2, N=2048, I=8)
    args = (torch.from_numpy(pts), torch.from_numpy(lab.astype(np.int64)),
            torch.from_numpy(K))
    runs = [tf.solve_frustum_batch(*args, H=H, W=W, n_inits=20, max_iter=4,
                                   generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert runs[0][0].shape == (2, 4, 4) and runs[0][1].shape == (2,)
    with pytest.raises(ValueError, match="generator"):
        tf.solve_frustum_batch(*args, H=H, W=W)


def test_initial_guess_matches_jax():
    rng = np.random.default_rng(4)
    pts, lab, _, _, _ = problem(rng, B=3, N=1024, I=8)
    ang_j, val_j = jax.vmap(jf.initial_guess)(jnp.asarray(pts),
                                              jnp.asarray(lab))
    ang_t, val_t = tf.initial_guess(torch.from_numpy(pts),
                                    torch.from_numpy(lab))
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-5)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))


@pytest.mark.parametrize("aa", [[0.0, 0.7, 0.0], [0.3, -1.2, 2.0],
                                [1e-9, 0.0, 0.0]])
def test_rodrigues_and_pose_match_jax(aa):
    aa = np.asarray(aa, np.float32)
    np.testing.assert_allclose(tf.rodrigues(torch.from_numpy(aa)).numpy(),
                               np.asarray(jf.rodrigues(jnp.asarray(aa))),
                               atol=1e-6)
    th = np.array([aa[1], 0.5, -0.1, 3.0], np.float32)
    np.testing.assert_allclose(tf.theta_to_pose(torch.from_numpy(th)).numpy(),
                               np.asarray(jf.theta_to_pose(jnp.asarray(th),
                                                           True)), atol=1e-6)


def test_pose_diff_matches_jax_and_summary():
    rng = np.random.default_rng(6)
    th = rng.normal(size=(5, 4)).astype(np.float32)
    P1 = tf.theta_to_pose(torch.from_numpy(th))
    P2 = tf.theta_to_pose(torch.from_numpy(th + 0.05))
    rte_t, rre_t = tm.pose_diff(P1, P2)
    rte_j, rre_j = jm.pose_diff(jnp.asarray(P1.numpy()),
                                jnp.asarray(P2.numpy()))
    np.testing.assert_allclose(rte_t.numpy(), np.asarray(rte_j), atol=1e-5)
    np.testing.assert_allclose(rre_t.numpy(), np.asarray(rre_j), atol=1e-3)
    s_t = tm.registration_summary(rte_t.numpy(), rre_t.numpy())
    s_j = jm.registration_summary(rte_t.numpy(), rre_t.numpy())
    assert s_t == s_j
