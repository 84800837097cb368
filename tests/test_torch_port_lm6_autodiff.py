"""The 6-DoF LM's plain version in the cluster layout's sum orders against
the JAX package's autodiff LM, ``frustum.lm_solve(is_2d=False)``, on
test_torch_port_lm6_cluster.py's problems and plans (see there for why
these seeds), at the same tolerances.  A file of its own: each JAX solver
compiles for a few tens of seconds on one core."""
import functools

import numpy as np
import pytest

from test_torch_port_lm6 import problem6, run_jax_generic
from test_torch_port_lm6_cluster import CASES, ITERS, N, run_plain


@functools.lru_cache(maxsize=None)
def autodiff_result(seed, max_iter):
    return run_jax_generic(problem6(seed, B=2, N=N, I=8), max_iter)


@pytest.mark.parametrize("seed,plan,streamed", CASES)
@pytest.mark.parametrize("max_iter,rtol", ITERS)
def test_lm6_cluster_order_matches_jax_autodiff_lm(seed, plan, streamed,
                                                   max_iter, rtol,
                                                   monkeypatch):
    th_t, c_t = run_plain(seed, plan, streamed, max_iter, monkeypatch)
    th_j, c_j = autodiff_result(seed, max_iter)
    np.testing.assert_allclose(c_t, c_j, rtol=rtol, atol=0)
    if max_iter == 1:
        np.testing.assert_allclose(th_t, th_j, rtol=0, atol=1e-4)
