"""The port's train step against the JAX package's ``Engine``: one tiny f32
step from the same weights, batch-norm statistics and batch, dropout off
on both sides (flax's ``Dropout`` patched to the identity in the JAX
model, the rates set to 0 in the port), the JAX kNN as the Pallas kernel
in interpret mode.  Loss and metrics within 1e-5 relative, every gradient
leaf within 1e-4 relative norm, the updated batch-norm statistics within
1e-5 relative (absolute near 0: the first convolution's variances reach
~400, where one f32 ulp is 3e-5).  Adam and the schedule, fed the JAX
gradients, against optax over three steps across a decay boundary
within 1e-6.  One JAX compile (the
train step) per file."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.train.engine import Engine as JaxEngine, TrainState
from deepi2p_tpu.train.engine import make_lr_schedule as jax_schedule
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.models import INPUT_KEYS, load_state_dict
from deepi2p_tpu_torch.models.from_jax import (flax_from_state_dict,
                                               state_dict_from_flax)
from deepi2p_tpu_torch.train.engine import (Engine, adam_update,
                                            make_lr_schedule)

from test_torch_port_checkpoint import calibrated, interpret_knn
from test_torch_port_train_parts import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_TOL = 1e-5
ADAM_RTOL = 1e-6
WARM_STEPS = 6


class NoDropout(flax_nn.Module):
    """flax ``Dropout`` with the rate ignored (the identity)."""
    rate: float = 0.0
    deterministic: bool = True

    def __call__(self, x, deterministic=None, rng=None):
        return x


def _capture(tx):
    """``tx`` whose state also carries the last gradients it was fed."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)
    return optax.GradientTransformation(init, update)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_state(params, stats, steps_per_epoch=4, **cfg):
    """The port's tiny engine (``cfg`` overrides the preset's fields) and a
    state with these flax weights (None: its seeded ones), its head's
    dropout off."""
    engine = Engine(tconfig.tiny(**cfg), steps_per_epoch=steps_per_epoch,
                    device="cpu")
    state = engine.init_state(seed=5)
    if params is not None:
        load_state_dict(state.model, state_dict_from_flax(params, stats))
    for layer in state.model.per_point_pn.layers:
        layer.dropout_rate = 0.0
    return engine, state


@pytest.fixture(scope="module")
def jax_step():
    """One JAX ``_train_step_impl`` at step 0 of the tiny config (f32);
    its gradients ride in the optimiser state.

    The weights are the port's seeded ones (the JAX package's
    initialisers) after ``WARM_STEPS`` steps of the port's trainer on the
    batch, on one thread; the running statistics are calibrated on the
    batch (means the batch's, variances one above, as
    ``test_torch_port_detector.py`` does; the batch statistics come from
    the port's train-mode forward, which the test below holds to flax's,
    to save a second JAX compile).  The tiny network's f32 gradient does
    not resolve 1e-4 at every point: at the seeded weights most leaves of
    the port's f32 gradient sit more than 1e-4 from a float64 copy of the
    port, and so do the JAX package's, so no f32 comparison can resolve
    1e-4 there.  After these steps the port's sits within 1e-5 of it in
    every leaf (``test_torch_port_train_cond.py`` holds the port to both
    and prints the JAX package's readings)."""
    cfg = jconfig.tiny()
    batch = jax_synthetic_batch(cfg, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with interpret_knn(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", NoDropout)
        eng = JaxEngine(cfg, steps_per_epoch=4)
        engine, warm = _port_state(None, None)
        gen = torch.Generator().manual_seed(0)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)      # one sum order: one trajectory
        try:
            for _ in range(WARM_STEPS):
                engine.train_step(warm, batch, gen)
        finally:
            torch.set_num_threads(threads)
        params, stats0 = flax_from_state_dict(warm.model.state_dict())
        with torch.no_grad():
            warm.model.train()(*(torch.from_numpy(batch[k])
                                 for k in INPUT_KEYS))
        stats = calibrated(flax_from_state_dict(warm.model.state_dict())[1],
                           stats0)
        eng.tx = _capture(eng.tx)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=eng.tx.init(params))
        new, metrics = jax.jit(eng._train_step_impl)(
            state, jb, jax.random.PRNGKey(0))
    return dict(batch=batch, params=params, stats=stats,
                grads=jax.tree.map(np.asarray, new.opt_state[1]),
                new_stats=jax.tree.map(np.asarray, new.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()})


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def test_train_step_metrics_and_stats_match_jax(jax_step):
    engine, state = _port_state(jax_step["params"], jax_step["stats"])
    state, metrics = engine.train_step(state, jax_step["batch"],
                                       torch.Generator().manual_seed(0))
    want = jax_step["metrics"]
    assert set(metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                   atol=0, err_msg=k)
    assert state.step == 1 and want["fine_violations"] == 0
    _, stats = flax_from_state_dict(state.model.state_dict())
    got, ref = _flat(stats), _flat(jax_step["new_stats"])
    assert set(got) == set(ref) and len(ref) > 20
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=k)


def test_gradients_match_jax_leaf_by_leaf(jax_step):
    """Each leaf within 1e-4 of its norm, except the 22 biases whose
    gradient is zero in exact arithmetic: every Linear bias that feeds a
    train-mode batch norm (the norm subtracts any per-channel shift), the
    last biases of ``node_a_pn`` and ``node_b_pn`` (interpolated into the
    head, whose first norm subtracts the shift) and the offset of the
    encoder's last norm (through a max over nodes into ``node_b_pn``'s
    norms).  Both frameworks hold rounding noise there, ~1e-8; such a
    leaf must stay below 1e-6 of the norm of the whole gradient on both
    sides (the smallest other leaf is ~5e-4 of it)."""
    engine, state = _port_state(jax_step["params"], jax_step["stats"])
    _, _, grads = engine.loss_and_grads(state, jax_step["batch"],
                                        torch.Generator().manual_seed(0))
    names = [n for n, _ in state.model.named_parameters()]
    got = _flat(flax_from_state_dict(dict(zip(names, grads)))[0])
    ref = _flat(jax_step["grads"])
    assert set(got) == set(ref) and len(ref) > 100
    total = [np.sqrt(sum(np.sum(np.square(t[k], dtype=np.float64))
                         for k in t)) for t in (got, ref)]

    def noise(k):
        return all(np.linalg.norm(t[k]) <= 1e-6 * n
                   for t, n in zip((got, ref), total))
    zeros = [k for k in ref if noise(k)]
    assert len(zeros) == 22 and all(k.endswith("['bias']") for k in zeros)
    for k in ref:
        if k not in zeros:
            assert _rel(got[k], ref[k]) <= GRAD_RTOL, (k, _rel(got[k], ref[k]))


def test_adam_and_schedule_match_optax(jax_step):
    """Three Adam steps fed the JAX gradients (scaled 1, -0.5, 2), at an
    lr that halves after the second step (one step per epoch, decay every
    2 epochs): the moments within 1e-6 relative of optax's, each
    parameter within 1e-6 of its leaf's largest magnitude (an updated
    weight near 0 is the difference of two ~1e-3 numbers)."""
    jcfg = jconfig.tiny(lr_decay_step=2)
    tcfg = tconfig.tiny(lr_decay_step=2)
    sched_j, sched_t = jax_schedule(jcfg, 1), make_lr_schedule(tcfg, 1)
    assert [sched_t(s) for s in range(3)] == [
        float(sched_j(jnp.asarray(s, jnp.int32))) for s in range(3)]
    assert sched_t(2) == sched_t(0) / 2
    tx = optax.adam(sched_j, b1=0.9, b2=0.999)
    # Adam is elementwise: all leaves side by side in one vector give the
    # same arithmetic and one small optax compile
    flat_p, flat_g = _flat(jax_step["params"]), _flat(jax_step["grads"])
    keys = list(flat_p)
    sizes = np.cumsum([0] + [flat_p[k].size for k in keys])
    p0 = np.concatenate([flat_p[k].ravel() for k in keys])
    g0 = np.concatenate([flat_g[k].ravel() for k in keys])

    @jax.jit
    def step(params, opt, grads):
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), opt

    params = {"w": jnp.asarray(p0)}
    opt = tx.init(params)
    p_t = [torch.from_numpy(p0.copy())]
    mu, nu = [torch.zeros_like(p_t[0])], [torch.zeros_like(p_t[0])]
    for count, scale in enumerate((1.0, -0.5, 2.0)):
        g = np.float32(scale) * g0
        params, opt = step(params, opt, {"w": jnp.asarray(g)})
        adam_update(p_t, [torch.from_numpy(g)], mu, nu, count,
                    sched_t(count))
    np.testing.assert_allclose(mu[0].numpy(), np.asarray(opt[0].mu["w"]),
                               rtol=ADAM_RTOL, atol=1e-30)
    np.testing.assert_allclose(nu[0].numpy(), np.asarray(opt[0].nu["w"]),
                               rtol=ADAM_RTOL, atol=1e-30)
    got, want = p_t[0].numpy(), np.asarray(params["w"])
    for i, k in enumerate(keys):
        sl = slice(sizes[i], sizes[i + 1])
        np.testing.assert_allclose(
            got[sl], want[sl], rtol=0,
            atol=ADAM_RTOL * float(np.abs(want[sl]).max()), err_msg=k)
