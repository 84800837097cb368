"""The port's ``SubsampleEnsemble`` against the JAX package's: on the stub
engines of ``tests/test_dump_ensemble.py`` (per-point functions, subset-
context terms, keep-last and averaged fine cells) the same seed gives
identical probabilities and fine cells; on real engines at a tiny config
(JAX ``Engine`` vs the port's ``Engine`` on the same exported weights)
the probabilities agree within 1e-5 and the decisions exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.eval.dump import SubsampleEnsemble as JaxEnsemble
from deepi2p_tpu.train.checkpoint import export_npz
from deepi2p_tpu.train.engine import Engine as JaxEngine, TrainState
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.eval.dump import SubsampleEnsemble
from deepi2p_tpu_torch.models import INPUT_KEYS
from deepi2p_tpu_torch.train.checkpoint import load_detector_npz
from deepi2p_tpu_torch.train.engine import Engine

from test_dump_ensemble import _batch, _FineProbStub, _StubEngine
from test_torch_port_checkpoint import interpret_knn, random_state


class _ContextStub(_StubEngine):
    """Inside probability with a subset-context term, no fine head (the
    JAX test's ``_ContextStub``)."""

    def infer_probs(self, state, b):
        pc = np.asarray(b["pc"])
        p = 1.0 / (1.0 + np.exp(-(pc[..., 0] + 3.0 * pc[..., 1].mean())))
        return p.astype(np.float32), None


STUBS = {
    "per_point": lambda sub_n: _StubEngine(sub_n),
    "context": lambda sub_n: _ContextStub(sub_n),
    "fine_probs": lambda sub_n: _FineProbStub(sub_n),
    "fine_probs_context": lambda sub_n: _FineProbStub(sub_n,
                                                      context_scale=3.2),
}


@pytest.mark.parametrize("stub", sorted(STUBS))
@pytest.mark.parametrize("N,sub_n,repeats", [(96, 32, 1), (100, 32, 3),
                                             (64, 64, 2), (24, 32, 1)])
def test_ensemble_matches_jax_on_stub_engines(stub, N, sub_n, repeats):
    batch = _batch(np.random.default_rng(N + repeats), 2, N)
    j_eng, t_eng = STUBS[stub](sub_n), STUBS[stub](sub_n)
    p_j, f_j = JaxEnsemble(j_eng, seed=5, repeats=repeats).infer_probs(
        None, batch)
    p_t, f_t = SubsampleEnsemble(t_eng, seed=5, repeats=repeats).infer_probs(
        None, batch)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    if f_j is None:
        assert f_t is None
    else:
        np.testing.assert_array_equal(f_t.numpy(), f_j)
    assert len(t_eng.calls) == len(j_eng.calls)
    for ct, cj in zip(t_eng.calls, j_eng.calls):
        assert ct == cj
    coarse, _ = SubsampleEnsemble(STUBS[stub](sub_n), seed=5,
                                  repeats=repeats).infer(None, batch)
    np.testing.assert_array_equal(coarse.numpy(), (p_j > 0.5))


@pytest.fixture(scope="module")
def real_engines(tmp_path_factory):
    """Tiny config, N=256 dumped, the network at sub_n=96; the JAX engine
    and the port's engine on the same exported weights."""
    cfg = jconfig.tiny()
    batch = jax_synthetic_batch(cfg, seed=4)
    ecfg = cfg.replace(input_pt_num=96)
    sub = jax_synthetic_batch(ecfg, seed=4)
    with interpret_knn():
        eng = JaxEngine(ecfg)
        params, stats = random_state(
            eng.model, [jnp.asarray(sub[k]) for k in INPUT_KEYS], seed=2)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       batch_stats=stats, opt_state=None)
    path = tmp_path_factory.mktemp("ens") / "w.npz"
    export_npz(state, str(path))
    t_eng = Engine(tconfig.tiny(input_pt_num=96), device="cpu")
    t_state = t_eng.init_state()
    load_detector_npz(t_state, str(path))
    return batch, (eng, state), (t_eng, t_state)


@pytest.mark.parametrize("repeats", [1, 2])
def test_ensemble_matches_jax_on_real_engines(real_engines, repeats):
    """Same subsets and nodes (seed 3); the averaged inside probability
    within 1e-5 absolute, the coarse decisions and the argmax of the
    averaged fine softmax equal."""
    batch, (eng, state), (t_eng, t_state) = real_engines
    with interpret_knn():
        p_j, f_j = JaxEnsemble(eng, seed=3, repeats=repeats).infer_probs(
            state, batch)
    p_t, f_t = SubsampleEnsemble(t_eng, seed=3,
                                 repeats=repeats).infer_probs(t_state, batch)
    assert p_t.shape == (2, 256) and f_t.shape == (2, 256)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(p_t.numpy() > 0.5, p_j > 0.5)
    np.testing.assert_array_equal(f_t.numpy(), f_j)


def test_engine_without_fine_probs_keeps_last_cells(real_engines):
    """Engines without ``infer_probs_fine`` take the keep-last integer
    cells (the JAX package's fallback): the same cells as the JAX
    ensemble over the JAX engine's ``infer_probs``."""
    batch, (eng, state), (t_eng, t_state) = real_engines

    def without_fine_probs(e):
        class Wrapped:
            cfg = e.cfg
            device = getattr(e, "device", None)
            infer_probs = staticmethod(e.infer_probs)
        return Wrapped()

    with interpret_knn():
        p_j, f_j = JaxEnsemble(without_fine_probs(eng), seed=1).infer_probs(
            state, batch)
    p_t, f_t = SubsampleEnsemble(without_fine_probs(t_eng),
                                 seed=1).infer_probs(t_state, batch)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=1e-5)
    assert f_t.dtype == torch.int64
    np.testing.assert_array_equal(f_t.numpy(), f_j)
