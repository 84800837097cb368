"""The port's checkpoints both ways: the inverse weight mapping
(``models/from_jax.py::flax_from_state_dict``) round-trips the committed
``ckpts/kitti_shape_r4/latest.npz`` bitwise through the port's
``export_npz``; a port-written ``.npz`` loads in the JAX package's
``warm_start_npz(partial=False)`` and gives the port's forward; a JAX
``export_npz`` warm-starts the port partially across geometries with the
JAX rules; and ``CheckpointManager`` saves, keeps and restores full train
states."""
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.models import KeypointDetector as JaxDetector
from deepi2p_tpu.train.checkpoint import export_npz as jax_export_npz
from deepi2p_tpu.train.checkpoint import warm_start_npz as jax_warm_start
from deepi2p_tpu.train.engine import TrainState as JaxTrainState
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.models import INPUT_KEYS, KeypointDetector
from deepi2p_tpu_torch.models.from_jax import (flax_from_state_dict,
                                               load_state_dict,
                                               state_dict_from_flax)
from deepi2p_tpu_torch.train import checkpoint
from deepi2p_tpu_torch.train.checkpoint import (CheckpointManager,
                                                export_npz, flat_arrays,
                                                load_detector_npz,
                                                warm_start_npz)
from deepi2p_tpu_torch.train.engine import Engine, TrainState

from test_torch_port_checkpoint import calibrated, interpret_knn, \
    random_weights
from test_torch_port_train_parts import one_torch_thread  # noqa: F401
from torch_port_fixtures import tmp_path  # noqa: F401

CKPT = Path(__file__).resolve().parents[1] / "ckpts/kitti_shape_r4/latest.npz"


def test_committed_checkpoint_round_trips_bitwise(tmp_path):
    """load -> the port's model -> ``export_npz``: the same 305 keys (194
    params, 110 batch_stats leaves, ``__step__``), each value equal in
    dtype, shape and bits."""
    model = KeypointDetector(tconfig.kitti())
    step = load_detector_npz(model, str(CKPT))
    out = tmp_path / "again.npz"
    export_npz(TrainState(model, [], [], step=step), str(out))
    with np.load(CKPT) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)
        assert sum(k.startswith("params[") for k in a.files) == 194
        assert sum(k.startswith("batch_stats[") for k in a.files) == 110
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    assert step == 32768


def test_port_npz_warm_starts_jax_and_forwards_agree(tmp_path):
    """A port state (seeded weights, running statistics calibrated on the
    batch by the port's train-mode forward) through ``export_npz`` into
    the JAX ``warm_start_npz(partial=False)``: every leaf arrives
    bitwise, the step too, and the JAX eval forward gives the port's
    logits within 1e-4 (f32, tiny)."""
    cfg = tconfig.tiny()
    batch = jax_synthetic_batch(jconfig.tiny(), seed=0)
    engine = Engine(cfg, device="cpu")
    state = engine.init_state(seed=2)
    stats0 = flax_from_state_dict(state.model.state_dict())[1]
    with torch.no_grad():
        state.model.train()(*(torch.from_numpy(batch[k])
                              for k in INPUT_KEYS),
                            generator=torch.Generator().manual_seed(0))
    cal = calibrated(flax_from_state_dict(state.model.state_dict())[1],
                     stats0)
    params = flax_from_state_dict(state.model.state_dict())[0]
    path = str(tmp_path / "port.npz")
    load_state_dict(state.model, state_dict_from_flax(params, cal))
    state.step = 123
    export_npz(state, path)

    jmodel = JaxDetector(jconfig.tiny())
    inputs = [jnp.asarray(batch[k]) for k in INPUT_KEYS]
    p_shape, s_shape = random_weights(jmodel, inputs, seed=0)
    template = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p_shape,
                             batch_stats=s_shape, opt_state=None)
    jstate = jax_warm_start(template, path, optax.adam(1e-3))
    assert int(jstate.step) == 123
    want = flat_arrays(state.model)
    for root, tree in (("params", jstate.params),
                       ("batch_stats", jstate.batch_stats)):
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = root + jax.tree_util.keystr(p)
            assert np.asarray(v).tobytes() == want.pop(key).tobytes(), key
    assert not want
    with interpret_knn():
        cj, fj = jmodel.apply({"params": jstate.params,
                               "batch_stats": jstate.batch_stats}, *inputs,
                              train=False)
    with torch.no_grad():
        ct, ft = state.model.eval()(*(torch.from_numpy(batch[k])
                                      for k in INPUT_KEYS))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """A JAX ``export_npz`` of random tiny weights at step 777."""
    cfg = jconfig.tiny()
    batch = jax_synthetic_batch(cfg, seed=0)
    params, stats = random_weights(
        JaxDetector(cfg), [jnp.asarray(batch[k]) for k in INPUT_KEYS], 1)
    path = str(tmp_path_factory.mktemp("jax") / "a.npz")
    jax_export_npz(JaxTrainState(step=jnp.asarray(777, jnp.int32),
                                 params=params, batch_stats=stats,
                                 opt_state=None), path)
    yield path
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def test_jax_npz_warm_starts_the_port_across_geometries(jax_npz, tmp_path,
                                                        monkeypatch):
    """The JAX rules (``tests/test_train.py:223``): strict refuses the
    64x128 model (fine head 8 classes, not 6); partial transfers every
    leaf whose shape matches, keeps the fresh init for the rest, resets
    the step and the Adam moments; a file with too few matching leaves is
    refused unless ``MIN_TRANSFER_FRAC`` is 0; strict into the same geometry
    takes the file's step."""
    engine = Engine(tconfig.tiny(img_W=128), device="cpu")
    template = engine.init_state(seed=1)
    fresh = flat_arrays(template.model)
    with pytest.raises(ValueError,
                       match=r"snapshot \(24,\) != template \(32,\)"):
        warm_start_npz(engine.init_state(seed=1), jax_npz)
    state = engine.init_state(seed=1)
    state.step = 5
    state.mu[0].fill_(1.0)
    warm_start_npz(state, jax_npz, partial=True)
    assert state.step == 0 and float(state.mu[0].abs().sum()) == 0.0
    got = flat_arrays(state.model)
    n_match = n_skip = 0
    with np.load(jax_npz) as z:
        for key, v in got.items():
            if z[key].shape == v.shape:
                np.testing.assert_array_equal(v, z[key])
                n_match += 1
            else:
                np.testing.assert_array_equal(v, fresh[key])
                n_skip += 1
        few = {k: z[k] for k in list(z.files)[:3]}
    assert n_skip > 0 and n_match > 10 * n_skip
    few["__step__"] = np.asarray(777)
    drifted = str(tmp_path / "drifted.npz")
    np.savez(drifted, **few)
    with pytest.raises(ValueError, match="near-cold start"):
        warm_start_npz(engine.init_state(seed=1), drifted, partial=True)
    monkeypatch.setattr(checkpoint, "MIN_TRANSFER_FRAC", 0.0)
    warm_start_npz(engine.init_state(seed=1), drifted, partial=True)
    same = Engine(tconfig.tiny(), device="cpu").init_state(seed=1)
    assert warm_start_npz(same, jax_npz).step == 777


def _equal_states(a: TrainState, b: TrainState):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))


def test_checkpoint_manager_round_trip_and_retention(tmp_path):
    """Save -> restore gives the model, both moments and the step back
    exactly; files are renamed into place (no temporary left); the
    newest ``max_to_keep`` stay, and steps on ``keep_period`` outside
    that window too; ``restore`` of an empty directory raises."""
    cfg = tconfig.tiny()
    engine = Engine(cfg, steps_per_epoch=2, device="cpu")
    state = engine.init_state(seed=0)
    batch = jax_synthetic_batch(jconfig.tiny(), seed=1)
    gen = torch.Generator().manual_seed(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2,
                            keep_period=3)
    with pytest.raises(FileNotFoundError):
        mgr.restore(engine.init_state(seed=1))
    assert mgr.latest_step() is None
    for _ in range(5):
        engine.train_step(state, batch, gen)
        mgr.save(state, metrics={"loss": 1.0})
    assert mgr.all_steps() == [3, 4, 5]
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    other = engine.init_state(seed=1)
    mgr.restore(other)
    _equal_states(state, other)
    mgr.restore(other, step=3)
    assert other.step == 3
    # the restored state trains on as the saved one would
    again = engine.init_state(seed=1)
    CheckpointManager(mgr.directory).restore(again, step=5)
    a, _ = engine.train_step(state, batch, torch.Generator().manual_seed(4))
    b, _ = engine.train_step(again, batch, torch.Generator().manual_seed(4))
    _equal_states(a, b)
