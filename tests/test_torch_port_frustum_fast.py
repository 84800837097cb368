"""The port's analytic-Jacobian LM (``register/frustum_fast.py``) and the
``backend`` routes of its ``solve_frustum_batch`` against the JAX
package's ``frustum_fast`` and its ``backend="xla"`` solve, from the same
``theta0``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register import frustum as jf
from deepi2p_tpu.register import frustum_fast as jff
from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.register import frustum_fast as tff

from test_torch_port_lm import H, T_LB, T_UB, W, problem
from test_torch_port_train_parts import one_torch_thread  # noqa: F401

COST_RTOL = 1e-4
THETA_ATOL = 1e-3
POSE_ATOL = 1e-3


def _intrinsics(K):
    """fx, fy, cx, cy as (B, 1, 1) arrays."""
    return (K[:, None, 0:1, 0], K[:, None, 1:2, 1], K[:, None, 0:1, 2],
            K[:, None, 1:2, 2])


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(5)
    pts, lab, valid, K, th0 = problem(rng, B=2, N=2048, I=16)
    return pts, lab, valid, K, th0.astype(np.float32)


def test_normal_equations_match_jax(prob):
    """H, g and the cost at several thetas within 1e-4 relative (to the
    largest entry of each), and the cost pass alone."""
    pts, lab, valid, K, th0 = prob
    args_t = [torch.as_tensor(pts[:, None, :, d]) for d in range(3)]
    args_j = [jnp.asarray(pts[:, None, :, d]) for d in range(3)]
    lt, vt = torch.as_tensor(lab[:, None]), torch.as_tensor(valid[:, None])
    lj, vj = jnp.asarray(lab[:, None]), jnp.asarray(valid[:, None])
    kt = _intrinsics(torch.as_tensor(K))
    kj = _intrinsics(jnp.asarray(K))
    H1, W1 = float(H - 1), float(W - 1)
    Ht, gt, ct = tff._normal_equations(torch.as_tensor(th0), *args_t, lt, vt,
                                       *kt, H1, W1)
    Hj, gj, cj = jff._normal_equations(jnp.asarray(th0), *args_j, lj, vj,
                                       *kj, H1, W1)
    Hj, gj, cj = (np.asarray(x) for x in (Hj, gj, cj))
    scale_H = np.abs(Hj).max(axis=(-2, -1), keepdims=True)
    scale_g = np.abs(gj).max(axis=-1, keepdims=True)
    assert np.all(np.abs(Ht.numpy() - Hj) <= 1e-4 * scale_H)
    assert np.all(np.abs(gt.numpy() - gj) <= 1e-4 * scale_g)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4)
    c2 = tff._residual_cost(torch.as_tensor(th0), *args_t, lt, vt, *kt,
                            H1, W1)
    np.testing.assert_allclose(c2.numpy(), cj, rtol=1e-4)


def _fast_jax(arrays, max_iter):
    th, c, n = jff.lm_solve_fast(*(jnp.asarray(x) for x in arrays),
                                 jnp.asarray(T_LB), jnp.asarray(T_UB), H=H,
                                 W=W, max_iter=max_iter)
    return np.asarray(th), np.asarray(c), np.asarray(n)


def _fast_port(arrays, max_iter):
    th, c, n = tff.lm_solve_fast(*(torch.as_tensor(x) for x in arrays),
                                 T_LB, T_UB, H=H, W=W, max_iter=max_iter)
    assert th.dtype == c.dtype == torch.float32 and n.dtype == torch.int32
    return th.numpy(), c.numpy(), n.numpy()


def _share(a, b):
    """Share of inits of two solves (theta, cost, n) whose costs agree
    within COST_RTOL relative and thetas within THETA_ATOL."""
    c_ok = np.abs(a[1] - b[1]) <= COST_RTOL * np.maximum(np.abs(b[1]), 1e-6)
    t_ok = np.all(np.abs(a[0] - b[0]) <= THETA_ATOL, axis=-1)
    return float(np.mean(c_ok & t_ok))


@pytest.mark.parametrize("max_iter", [1, 8])
def test_lm_solve_fast_matches_jax(prob, max_iter):
    """Costs within 1e-4 relative and theta within 1e-3 for >= 99% of the
    inits, and the same accepted-step counts."""
    pts, lab, valid, K, th0 = prob
    arrays = (pts, lab, valid, K, th0)
    port, ref = _fast_port(arrays, max_iter), _fast_jax(arrays, max_iter)
    assert _share(port, ref) >= 0.99
    assert np.mean(port[2] == ref[2]) >= 0.99


def test_lm_solve_fast_long_run_matches_jax(prob):
    """At 32 iterations the trajectories of some inits part: their points
    cross frame edges, and a rounding of the sums over points decides an
    accept.  The JAX solver parts from itself as often when only the
    order of the points changes, so the port is held to that: it agrees
    with the JAX solve on at least as many inits, less 5 points of share,
    as the JAX solve of the permuted points does; and the best init of
    every pair within 1e-4 relative."""
    pts, lab, valid, K, th0 = prob
    arrays = (pts, lab, valid, K, th0)
    perm = np.random.default_rng(0).permutation(pts.shape[1])
    permuted = (pts[:, perm], lab[:, perm], valid[:, perm], K, th0)
    ref = _fast_jax(arrays, 32)
    own = _share(_fast_jax(permuted, 32), ref)
    port = _fast_port(arrays, 32)
    assert _share(port, ref) >= own - 0.05, (_share(port, ref), own)
    np.testing.assert_allclose(port[1].min(axis=1), ref[1].min(axis=1),
                               rtol=COST_RTOL)


def _jax_solve(pc, pred, K, theta0, **kw):
    P, cost = jf.solve_frustum_batch(jnp.asarray(pc), jnp.asarray(pred),
                                     jnp.asarray(K), H=H, W=W,
                                     theta0=jnp.asarray(theta0),
                                     backend="xla", **kw)
    return np.asarray(P), np.asarray(cost)


def _port_solve(pc, pred, K, theta0, **kw):
    P, cost = tf.solve_frustum_batch(torch.as_tensor(pc),
                                     torch.as_tensor(pred),
                                     torch.as_tensor(K), H=H, W=W,
                                     theta0=torch.as_tensor(theta0), **kw)
    return P.numpy(), cost.numpy()


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(17)
    pts, lab, _, K, _ = problem(rng, B=3, N=2048, I=8)
    pred = lab.astype(np.int32)
    pred[2] = 0                            # a pair with no inside points
    ang, _ = jax.vmap(jf.initial_guess)(jnp.asarray(pts), jnp.asarray(pred))
    theta0 = np.array(jax.vmap(lambda k, a: jf.sample_inits(k, a, 32))(
        jax.random.split(jax.random.PRNGKey(3), 3), ang), np.float32)
    return pts, pred, K, theta0


@pytest.mark.parametrize("kw", [
    dict(max_iter=24, solver_stride=2),           # probe 8, keep 8, refine
    dict(max_iter=16, survivors=5, solver_stride=2),  # keep 5
    dict(max_iter=6, solver_stride=2),            # probe only
])
def test_solve_fast_matches_jax_xla(pairs, kw):
    """``backend="fast"`` is the JAX package's ``backend="xla"``: poses
    within 1e-3, costs within 1e-4 relative; the empty pair gets the
    identity and 1e4 in both."""
    pts, pred, K, theta0 = pairs
    P_j, c_j = _jax_solve(pts, pred, K, theta0, **kw)
    P_t, c_t = _port_solve(pts, pred, K, theta0, backend="fast", **kw)
    np.testing.assert_allclose(P_t, P_j, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(c_t, c_j, rtol=COST_RTOL)
    assert c_t[2] == 1e4 and np.array_equal(P_t[2], np.eye(4))


def test_solve_fast_plan(pairs, monkeypatch):
    """The fast route's launches: a probe of min(8, max_iter) iterations
    on every init at the solver stride (no probe stride, no padding to 8),
    then max(I // 4, 4) survivors for the rest."""
    pts, pred, K, theta0 = pairs
    plan, fast = [], tf.lm_solve_fast

    def recording(p, lab, val, Kb, th, *a, max_iter, **k):
        plan.append((p.shape[1], th.shape[1], max_iter))
        return fast(p, lab, val, Kb, th, *a, max_iter=max_iter, **k)
    monkeypatch.setattr(tf, "lm_solve_fast", recording)
    _port_solve(pts, pred, K, theta0[:, :30], backend="fast", max_iter=24,
                solver_stride=2)
    assert plan == [(1024, 30, 8), (1024, 7, 16)]
    plan.clear()
    _port_solve(pts, pred, K, theta0[:, :6], backend="fast", max_iter=24)
    assert plan == [(2048, 6, 8)]


def test_backend_routes(pairs):
    """``auto`` and ``kernel`` are today's route, bitwise; ``generic`` is
    the autodiff route of a weighted cost; bad names raise."""
    pts, pred, K, theta0 = pairs
    theta0 = theta0[:, :8]
    kw = dict(max_iter=6, solver_stride=2)
    P0, c0 = _port_solve(pts, pred, K, theta0, **kw)
    for backend in ("auto", "kernel"):
        P1, c1 = _port_solve(pts, pred, K, theta0, backend=backend, **kw)
        assert np.array_equal(P0, P1) and np.array_equal(c0, c1)
    Pg, cg = _port_solve(pts, pred, K, theta0, backend="generic", **kw)
    res = tf.lm_solve_generic(
        torch.as_tensor(pts[:, ::2]),
        torch.as_tensor(pred[:, ::2].astype(np.float32)),
        tf.initial_guess(torch.as_tensor(pts),
                         torch.as_tensor(pred))[1][:, ::2],
        torch.as_tensor(K), torch.as_tensor(theta0), T_LB, T_UB, H=H, W=W,
        max_iter=6)
    np.testing.assert_array_equal(cg[:2], res.cost.min(dim=1).values[:2])
    with pytest.raises(ValueError, match="2-D"):
        _port_solve(pts, pred, K, np.zeros((3, 8, 6), np.float32),
                    backend="fast", is_2d=False)
    with pytest.raises(ValueError, match="unknown backend"):
        _port_solve(pts, pred, K, theta0, backend="xla")
