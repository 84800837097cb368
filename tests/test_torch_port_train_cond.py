"""Why the train-step parity test (``test_torch_port_train_step.py``)
starts where it does.  The tiny network's f32 gradient against a float64
copy of the port, at two points: the port's seeded weights, and the state
the parity test starts from (those weights after ``WARM_STEPS``
one-thread steps of the port's trainer).  Dropout is off.

The float64 copy is the port's model at ``compute_dtype="float64"``
with its weights in float64 (``ops.dtypes.widen`` keeps its statistics
and sums in f64); the kNN and the labels stay f32, as they are data.

At the seeded weights the port's f32 gradient sits more than 1e-4 from
float64 in most leaves, so no f32 comparison resolves the parity test's
1e-4 there; at the parity test's state it sits within 1e-5 in every
leaf, so that 1e-4 measures the port against JAX and not f32 against
itself.

``PYTHONPATH=. python tests/test_torch_port_train_cond.py`` prints the
readings at both points with the JAX package's f32 gradient beside them
(its kNN the Pallas kernel in interpret mode): the port and JAX each
against float64, and against each other."""
import numpy as np
import pytest
import torch

from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu import config as jconfig
from deepi2p_tpu_torch.models.from_jax import flax_from_state_dict

from test_torch_port_train_parts import one_torch_thread  # noqa: F401
from test_torch_port_train_step import WARM_STEPS, _flat, _port_state, _rel

RESOLVED = 1e-5      # the port's f32 against float64 at the parity state
UNRESOLVED = 1e-4    # the parity test's gradient tolerance


def _port_grads(params, stats, batch, f64: bool):
    """The port's loss and gradient leaves (flax keys, float64 numpy)."""
    engine, state = _port_state(
        params, stats, compute_dtype="float64" if f64 else "float32")
    if f64:
        state.model.double()
    loss, _, grads = engine.loss_and_grads(state, batch,
                                           torch.Generator().manual_seed(0))
    want = torch.float64 if f64 else torch.float32
    assert loss.dtype == want and all(g.dtype == want for g in grads)
    names = [n for n, _ in state.model.named_parameters()]
    tree = flax_from_state_dict({n: g.detach().double()
                                 for n, g in zip(names, grads)})[0]
    return float(loss), {k: v.astype(np.float64)
                         for k, v in _flat(tree).items()}


def points(batch):
    """(flax params, batch_stats) of the seeded weights and of the parity
    test's state."""
    engine, warm = _port_state(None, None)
    out = {"seeded": flax_from_state_dict(warm.model.state_dict())}
    gen = torch.Generator().manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # one sum order: the parity test's state
    try:
        for _ in range(WARM_STEPS):
            engine.train_step(warm, batch, gen)
    finally:
        torch.set_num_threads(threads)
    out["chosen"] = flax_from_state_dict(warm.model.state_dict())
    return out


def compare(params, stats, batch, others=None):
    """Per-leaf relative distances of the port's f32 gradient (and of each
    of ``others``, name -> flat gradient) from the port's float64 one,
    over the leaves that are not zero in exact arithmetic; the losses."""
    l32, port = _port_grads(params, stats, batch, f64=False)
    l64, f64 = _port_grads(params, stats, batch, f64=True)
    total = np.sqrt(sum(np.sum(np.square(v)) for v in f64.values()))
    keys = [k for k in f64 if np.linalg.norm(f64[k]) > 1e-6 * total]
    grads = {"port": port, **(others or {})}
    out = {f"{n}-f64": [_rel(g[k], f64[k]) for k in keys]
           for n, g in grads.items()}
    for n, g in (others or {}).items():
        out[f"port-{n}"] = [_rel(port[k], g[k]) for k in keys]
    return dict(losses={"port": l32, "f64": l64}, n=len(keys), rel=out)


@pytest.fixture(scope="module")
def port_readings():
    batch = jax_synthetic_batch(jconfig.tiny(), seed=0)
    return {name: compare(p, s, batch)
            for name, (p, s) in points(batch).items()}


def test_f32_resolves_the_parity_tests_state(port_readings):
    """The port's f32 gradient within 1e-5 of float64 in every leaf (the
    22 leaves that are zero in exact arithmetic left out)."""
    r = port_readings["chosen"]
    errs = r["rel"]["port-f64"]
    assert r["n"] == len(errs) > 100
    assert max(errs) <= RESOLVED, max(errs)
    assert 0 < min(errs)      # the copy really ran in float64


def test_f32_does_not_resolve_the_seeded_weights(port_readings):
    """At the seeded weights most leaves of the port's f32 gradient sit
    more than 1e-4 from float64: the parity test cannot start there."""
    r = port_readings["seeded"]
    assert sum(x > UNRESOLVED for x in r["rel"]["port-f64"]) > r["n"] // 2


def main() -> None:
    """Both points with the JAX package's f32 gradient: one compile of the
    JAX train step, its gradients carried out in the optimiser state."""
    import jax
    import jax.numpy as jnp
    from flax import linen as flax_nn

    from deepi2p_tpu.train.engine import Engine as JaxEngine, TrainState
    from test_torch_port_checkpoint import interpret_knn
    from test_torch_port_train_step import NoDropout, _capture

    cfg = jconfig.tiny()
    batch = jax_synthetic_batch(cfg, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with interpret_knn(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", NoDropout)
        eng = JaxEngine(cfg, steps_per_epoch=4)
        eng.tx = _capture(eng.tx)
        step = jax.jit(eng._train_step_impl)
        for name, (params, stats) in points(batch).items():
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats,
                               opt_state=eng.tx.init(params))
            new, metrics = step(state, jb, jax.random.PRNGKey(0))
            jax_g = {k: np.asarray(v, np.float64)
                     for k, v in _flat(new.opt_state[1]).items()}
            r = compare(params, stats, batch, {"jax": jax_g})
            print(f"{name}: loss port f32 {r['losses']['port']!r}, JAX f32 "
                  f"{float(metrics['loss'])!r}, port f64 "
                  f"{r['losses']['f64']!r}; {r['n']} leaves")
            for pair, e in r["rel"].items():
                e = sorted(e)
                print(f"  {pair}: max {e[-1]:.3g} median "
                      f"{e[len(e) // 2]:.3g}, over 1e-4 "
                      f"{sum(x > UNRESOLVED for x in e)}, over 1e-5 "
                      f"{sum(x > RESOLVED for x in e)}")


if __name__ == "__main__":
    main()
