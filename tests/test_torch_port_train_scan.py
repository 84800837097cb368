"""K train steps per call (``Engine.train_step_scan``, ``train.cli
--steps-per-dispatch``) on the CPU, ``config.tiny()``:

* the port's K = 3 call against the JAX ``Engine.train_step_scan`` from
  the same state and stacked batches (dropout off on both sides, the JAX
  kNN as the Pallas kernel in interpret mode), at bands tighter than
  those of JAX's own ``test_train_step_scan_matches_loop`` (loss 2e-2
  relative; parameters 0.05 relative plus 4 K lr): the last trip's loss
  within ``SCAN_LOSS_RTOL`` (7.8e-4 measured), every parameter within
  2 K lr (3.1e-3 = 1.03 K lr measured).  The state is the port's after
  ``WARM_STEPS`` steps, Adam moments and step count included: Adam's
  first steps move each weight by ~lr times the sign of its gradient,
  and f32 rounding flips the sign of the near-zero ones, so from fresh
  moments the third trip's loss parts by 2.5-31% between the two
  packages on 8 (weights, batches) seeds, as it parts by 1-21% between
  the port and itself from weights moved by 1e-6 relative; from warm
  moments it agreed within 4e-6 to 1.1e-3 on 6 seeds;
* the port's call against K ``train_step`` calls on the same generator,
  dropout on: bitwise (metrics, parameters, statistics, Adam moments);
  another generator seed gives another last-trip loss.

``tests/test_torch_port_train_scan_cli.py`` holds the CLI's K-step runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.train.engine import Engine as JaxEngine, TrainState
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.models.from_jax import flax_from_state_dict
from deepi2p_tpu_torch.train.engine import Engine
from test_torch_port_checkpoint import interpret_knn
from test_torch_port_train_step import NoDropout
from torch_port_fixtures import one_torch_thread  # noqa: F401

K = 3
WARM_STEPS = 4
SCAN_LOSS_RTOL = 5e-3     # JAX's own scan-against-loop band: 2e-2
PARAM_LRS = 2             # parameters within 2 K lr (JAX's band: 0.05
                          # relative plus 4 K lr)


def _batches(cfg, k=K):
    return [synthetic_batch(cfg, seed=10 + i) for i in range(k)]


def _stack(batches):
    return {key: torch.from_numpy(np.stack([b[key] for b in batches]))
            for key in batches[0]}


def _state(dropout: bool = True, warm: int = 0):
    """The tiny engine and its seeded state, after ``warm`` steps on the
    batches of seeds 100, 101, ..."""
    engine = Engine(tconfig.tiny(), steps_per_epoch=100, device="cpu")
    state = engine.init_state(seed=0)
    if not dropout:
        for layer in state.model.per_point_pn.layers:
            layer.dropout_rate = 0.0
    gen = torch.Generator().manual_seed(0)
    for i in range(warm):
        engine.train_step(state, synthetic_batch(tconfig.tiny(),
                                                 seed=100 + i), gen)
    return engine, state


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flax(state):
    """The port's state as JAX's: params, batch statistics and optax's
    Adam state (moments and counts), copied."""
    names = [n for n, _ in state.model.named_parameters()]
    params, stats = flax_from_state_dict(state.model.state_dict())
    mu, nu = (flax_from_state_dict(dict(zip(names, m)))[0]
              for m in (state.mu, state.nu))
    return jax.tree.map(np.array, (params, stats, mu, nu))


@pytest.fixture(scope="module")
def scans():
    """JAX's ``train_step_scan`` and the port's at K = 3 from the port's
    state after ``WARM_STEPS`` steps, on the port's host batches of seeds
    10-12; flax ``Dropout`` patched to the identity, the port's rates 0."""
    engine, state = _state(dropout=False, warm=WARM_STEPS)
    params, stats, mu, nu = _flax(state)
    batches = _batches(tconfig.tiny())
    stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    with interpret_knn(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", NoDropout)
        eng = JaxEngine(jconfig.tiny(), steps_per_epoch=100)
        adam, sched = eng.tx.init(params)

        def count():   # one buffer each: the scan donates its state
            return jnp.asarray(WARM_STEPS, jnp.int32)
        s0 = TrainState(step=count(), params=params, batch_stats=stats,
                        opt_state=(adam._replace(count=count(), mu=mu,
                                                 nu=nu),
                                   sched._replace(count=count())))
        new, metrics = eng.train_step_scan(s0, stacked,
                                           jax.random.PRNGKey(42))
    port = engine.train_step_scan(state, _stack(batches),
                                  torch.Generator().manual_seed(0))
    return dict(port=port, step=int(new.step),
                params=_flat(jax.tree.map(np.asarray, new.params)),
                metrics={k: float(v) for k, v in metrics.items()})


def test_scan_matches_jax_scan(scans):
    state, metrics = scans["port"]
    assert state.step == scans["step"] == WARM_STEPS + K
    want = scans["metrics"]
    assert set(metrics) == set(want)
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=SCAN_LOSS_RTOL)
    assert float(metrics["lr"]) == pytest.approx(want["lr"], rel=1e-7)
    got = _flat(flax_from_state_dict(state.model.state_dict())[0])
    ref = scans["params"]
    assert set(got) == set(ref) and len(ref) > 100
    lr = tconfig.tiny().lr
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=PARAM_LRS * K * lr, err_msg=k)


def _snapshot(state, metrics):
    sd = state.model.state_dict()
    return dict(step=state.step, sd={k: v.clone() for k, v in sd.items()},
                mu=[t.clone() for t in state.mu],
                nu=[t.clone() for t in state.nu],
                metrics={k: v.clone() for k, v in metrics.items()})


def _bitwise(a, b):
    assert a["step"] == b["step"]
    assert a["metrics"].keys() == b["metrics"].keys()
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
    for k in a["sd"]:
        assert torch.equal(a["sd"][k], b["sd"][k]), k
    for x, y in zip(a["mu"] + a["nu"], b["mu"] + b["nu"]):
        assert torch.equal(x, y)


def test_scan_is_the_steps_bitwise_and_follows_the_generator():
    """Dropout on: a K = 3 call is bitwise 3 single steps on one
    generator; another generator seed gives another last-trip loss."""
    batches = _batches(tconfig.tiny())
    engine, state = _state()
    gen = torch.Generator().manual_seed(7)
    for b in batches:
        state, metrics = engine.train_step(state, b, gen)
    loop = _snapshot(state, metrics)
    engine, state = _state()
    state, metrics = engine.train_step_scan(
        state, _stack(batches), torch.Generator().manual_seed(7))
    scan = _snapshot(state, metrics)
    assert scan["step"] == K
    _bitwise(scan, loop)
    engine, state = _state()
    _, other = engine.train_step_scan(state, _stack(batches),
                                      torch.Generator().manual_seed(8))
    assert float(other["loss"]) != float(scan["metrics"]["loss"])
