"""The port's PnP through the harness against the JAX package's, on the
JAX test's PnP dumps (``test_register_extra.py::
test_dump_roundtrip_and_harness``): fed the minimal sets of the very
Gumbel draws the JAX harness makes, ``solve_pnp_batch`` gives the JAX
harness's poses within 1e-4 and its costs within 1e-6; with the port's
own draws the harness's success over six seeds is the JAX harness's over
the same seeds."""
import jax
import numpy as np
import pytest
import torch

from deepi2p_tpu.eval.harness import evaluate_registration as jax_eval
from deepi2p_tpu_torch.eval.dump import list_dump_prefixes, load_dump
from deepi2p_tpu_torch.eval.harness import evaluate_registration
from deepi2p_tpu_torch.register.pnp import solve_pnp_batch

from test_register_extra import H, W
from test_torch_port_eval import _pnp_dumps
from test_torch_port_pnp import jax_subsets


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    out = tmp_path_factory.mktemp("pnp_dumps")
    _pnp_dumps(str(out), np.random.default_rng(5))
    return str(out)


def test_pnp_on_jax_draws_matches_jax_harness(dumps, tmp_path):
    """The JAX harness (seed 0, one chunk of 3 pairs) draws its hypotheses
    from ``split(split(PRNGKey(0))[1], 3)``; the port solves the same
    pairs on those draws."""
    jax_eval(dumps, method="pnp", H=H, W=W, batch_size=3,
             save_dir=str(tmp_path))
    P_j = np.load(tmp_path / "P_pred_all_np.npy")
    cost_j = np.load(tmp_path / "cost_all_np.npy")
    ds = [load_dump(dumps, p) for p in list_dump_prefixes(dumps)]
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(sub, len(ds))
    n = ds[0]["pc"].shape[0]
    g = np.stack([np.asarray(jax.random.gumbel(k, (500, n))) for k in keys])
    stack = [torch.as_tensor(np.stack([d[f] for d in ds]))
             for f in ("pc", "coarse_pred", "fine_pred", "K")]
    res = solve_pnp_batch(*stack, W_fine=int(round(W / 32)),
                          subset=jax_subsets(g, stack[1]))
    np.testing.assert_allclose(res.P.numpy(), P_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.cost.numpy(), cost_j, rtol=0, atol=1e-6)
    assert (cost_j < 1.0).sum() >= 2


def test_pnp_harness_success_matches_jax_over_seeds(dumps):
    """Per seed the two packages draw different hypotheses; over seeds 0-5
    the port's successes are at least the JAX harness's, less one (14
    and 12 of 18 when measured)."""
    kw = dict(method="pnp", H=H, W=W, batch_size=3)
    ok_t = ok_j = 0
    for seed in range(6):
        s_t = evaluate_registration(dumps, seed=seed, device="cpu", **kw)
        s_j = jax_eval(dumps, seed=seed, **kw)
        assert s_t["num_pairs"] == s_j["num_pairs"] == 3
        ok_t += round(3 * s_t["success_rate"])
        ok_j += round(3 * s_j["success_rate"])
    assert ok_t >= ok_j - 1, (ok_t, ok_j)
    assert ok_t >= 9
