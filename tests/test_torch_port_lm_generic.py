"""The port's generic autodiff LM (``lm_solve_generic``, the route of a
weighted or margin-relaxed frustum cost) against the JAX package's
``frustum.lm_solve``, in the 2-D and 6-DoF modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register import frustum as jf
from deepi2p_tpu_torch.register import frustum as tf

from test_torch_port_lm import H, T_LB, T_UB, W
from test_torch_port_lm6 import problem6


@pytest.mark.parametrize("is_2d", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_generic_lm_matches_jax(is_2d, weighted):
    """The port's autodiff LM (the JAX package's ``frustum.lm_solve``
    written for a batch) with and without the weighted, margin-relaxed
    cost: cost 1e-5 relative, theta 1e-4 absolute, equal accept counts,
    at 4 iterations."""
    pts, lab, val, K, th6 = problem6(21, B=2, N=512, I=4)
    th = th6 if not is_2d else th6[..., [1, 3, 4, 5]]
    kw = dict(outside_weight=0.5, edge_margin_px=3.0) if weighted else {}
    pw = np.random.default_rng(1).uniform(0.2, 1.0, (2, 512)).astype(
        np.float32) if weighted else None
    res_t = tf.lm_solve_generic(
        *(torch.from_numpy(a) for a in (pts, lab, val, K, th)), T_LB, T_UB,
        H=H, W=W, max_iter=3, is_2d=is_2d,
        point_weights=None if pw is None else torch.from_numpy(pw), **kw)

    def one(t, p, l, v, k, w):
        return jf.lm_solve(p, l, v, k, t, jnp.asarray(T_LB),
                           jnp.asarray(T_UB), H=H, W=W, max_iter=3,
                           is_2d=is_2d, point_weights=w, **kw)
    inner = jax.vmap(one, in_axes=(0, None, None, None, None, None))
    res_j = jax.vmap(inner, in_axes=(0, 0, 0, 0, 0,
                                     None if pw is None else 0))(
        *(jnp.asarray(a) for a in (th, pts, lab, val, K)),
        None if pw is None else jnp.asarray(pw))
    np.testing.assert_allclose(res_t.cost.numpy(), np.asarray(res_j.cost),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(res_t.theta.numpy(), np.asarray(res_j.theta),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res_t.n_accepted.numpy(),
                                  np.asarray(res_j.n_accepted))
