"""The port's 6-DoF ``solve_frustum_batch``, and its routing of a weighted
cost to the generic autodiff LM, against the JAX package's, on the same
inputs and inits.  Tolerances are stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepi2p_tpu.register import frustum as jf
from deepi2p_tpu_torch.register import frustum as tf

from test_torch_port_frustum import jax_halving_solve
from test_torch_port_lm import H, W, problem


def test_solve6_matches_jax_halving():
    """The 6-DoF solve_frustum_batch replayed from the same theta0 against
    the JAX package's Pallas branch (lm_solve_pallas interpret): cost
    1e-4 relative, pose 1e-3 absolute."""
    rng = np.random.default_rng(13)
    pts, lab, _, K, _ = problem(rng, B=1, N=1024, I=8)
    pred = lab.astype(np.int32)
    ang, _ = jax.vmap(jf.initial_guess)(jnp.asarray(pts), jnp.asarray(pred))
    theta0 = np.array(jax.vmap(lambda k, a: jf.sample_inits(
        k, a, 32, is_2d=False))(jax.random.split(jax.random.PRNGKey(0), 1),
                                ang))
    kw = dict(max_iter=9, solver_stride=2)
    P_j, c_j = jax_halving_solve(jnp.asarray(pts), jnp.asarray(pred),
                                 jnp.asarray(K), jnp.asarray(theta0),
                                 is_2d=False, **kw)
    P_t, c_t = tf.solve_frustum_batch(
        torch.from_numpy(pts), torch.from_numpy(pred), torch.from_numpy(K),
        H=H, W=W, theta0=torch.from_numpy(theta0), is_2d=False, **kw)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4)
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=0,
                               atol=1e-3)


def test_weighted_solve_routes_to_generic_and_matches_jax():
    """outside_weight != 1 and point weights take the generic autodiff
    path in both packages (full budget, no halving): same theta0, same
    result (cost 1e-4 relative, pose 1e-3 absolute)."""
    rng = np.random.default_rng(17)
    pts, lab, _, K, th4 = problem(rng, B=2, N=512, I=8)
    pred = lab.astype(np.int32)
    pw = rng.uniform(0.3, 1.0, (2, 512)).astype(np.float32)
    kw = dict(H=H, W=W, max_iter=4, outside_weight=0.7)
    P_j, c_j = jf.solve_frustum_batch(
        jnp.asarray(pts), jnp.asarray(pred), jnp.asarray(K),
        theta0=jnp.asarray(th4), point_weights=jnp.asarray(pw), **kw)
    P_t, c_t = tf.solve_frustum_batch(
        torch.from_numpy(pts), torch.from_numpy(pred), torch.from_numpy(K),
        theta0=torch.from_numpy(th4), point_weights=torch.from_numpy(pw),
        **kw)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4)
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=0,
                               atol=1e-3)
