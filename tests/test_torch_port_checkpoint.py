"""The port's ``.npz`` checkpoint loader and inference engine against the
JAX package: a JAX ``Engine`` state written by ``export_npz`` and read by
``train.checkpoint.load_detector_npz`` gives the JAX engine's argmax labels
exactly (f32, tiny config, no TF32 on the CPU), and a missing or
misshapen key raises and names it.  The committed checkpoint is held to
the JAX forward in ``test_torch_port_checkpoint_kitti.py``."""
import contextlib
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.ops import knn_pallas as jax_knn_pallas
from deepi2p_tpu.train.checkpoint import export_npz
from deepi2p_tpu.train.engine import Engine as JaxEngine, TrainState
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.models import INPUT_KEYS, KeypointDetector
from deepi2p_tpu_torch.train.checkpoint import load_detector_npz, load_npz
from deepi2p_tpu_torch.train.engine import Engine
from torch_port_fixtures import tmp_path  # noqa: F401


@contextlib.contextmanager
def interpret_knn():
    """The JAX forward's kNN as the Pallas kernel in interpret mode (the
    XLA path's |x|^2+|y|^2-2xy moves coincident points on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_knn_pallas, "pallas_eligible", lambda q, db, k: True)
        mp.setattr(jax_knn_pallas, "knn_pallas", functools.partial(
            jax_knn_pallas.knn_pallas, interpret=True))
        yield


def random_weights(model, inputs, seed: int):
    """Random flax params and batch statistics of ``model``, shapes from
    ``eval_shape`` (a compiled init takes ~30 s on one core): kernels
    ~ N(0, 1/fan_in), norm scales U(0.5, 1.5), biases and running means
    N(0, 0.1), running variances 1."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if name == "var":
            return np.ones(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(0.0, 1.0, s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *inputs, train=False))
    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats0 = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    return params, stats0


def calibrated(new_stats, old_stats):
    """Running means equal to a batch's own and variances one above its
    own, from the statistics ``old`` became after one train-mode pass over
    that batch (flax keeps ``0.9 * old + 0.1 * batch``)."""
    def leaf(path, new, old):
        batch = (np.asarray(new) - 0.9 * old) / 0.1
        return batch + 1.0 if path[-1].key == "var" else batch
    return jax.tree_util.tree_map_with_path(leaf, new_stats, old_stats)


def random_state(model, inputs, seed: int):
    """:func:`random_weights`, then running statistics calibrated on the
    batch (one jitted train-mode pass), which keeps the logits O(1) as
    ``test_torch_port_detector._calibrated_stats`` does."""
    params, stats0 = random_weights(model, inputs, seed)
    train = jax.jit(lambda p, s, *x: model.apply(
        {"params": p, "batch_stats": s}, *x, train=True,
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)}))
    _, upd = train(params, stats0, *inputs)
    return params, calibrated(upd["batch_stats"], stats0)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    """A tiny JAX Engine state with conditioned random weights, exported;
    the JAX engine's outputs on a batch."""
    cfg = jconfig.tiny()
    batch = jax_synthetic_batch(cfg, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with interpret_knn():
        eng = JaxEngine(cfg)
        params, stats = random_state(eng.model, [jb[k] for k in INPUT_KEYS],
                                     seed=0)
        state = TrainState(step=jnp.asarray(17, jnp.int32), params=params,
                           batch_stats=stats, opt_state=None)
        outs = dict(infer=eng.infer(state, jb),
                    infer_probs=eng.infer_probs(state, jb),
                    infer_probs_fine=eng.infer_probs_fine(state, jb))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    export_npz(state, str(path))
    yield path, batch, jax.tree.map(np.asarray, outs)
    shutil.rmtree(path.parent, ignore_errors=True)


def test_engine_on_exported_npz_matches_jax_engine(tiny_npz):
    """Argmax labels equal; probabilities within 1e-5 absolute."""
    path, batch, want = tiny_npz
    engine = Engine(tconfig.tiny(), device="cpu")
    state = engine.init_state(seed=3)
    assert load_detector_npz(state, str(path)) == 17
    coarse, fine = engine.infer(state, batch)
    np.testing.assert_array_equal(coarse.numpy(), want["infer"][0])
    np.testing.assert_array_equal(fine.numpy(), want["infer"][1])
    p, fine_arg = engine.infer_probs(state, batch)
    np.testing.assert_allclose(p.numpy(), want["infer_probs"][0], atol=1e-5)
    np.testing.assert_array_equal(fine_arg.numpy(), want["infer_probs"][1])
    p2, fine_p = engine.infer_probs_fine(state, batch)
    assert fine_p.shape == want["infer_probs_fine"][1].shape
    np.testing.assert_allclose(fine_p.numpy(), want["infer_probs_fine"][1],
                               atol=1e-5)
    np.testing.assert_array_equal(p2.numpy(), p.numpy())


def _rewrite(src, dst, edit):
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    edit(arrays)
    np.savez(dst, **arrays)
    return str(dst)


def test_load_is_strict_and_names_the_key(tiny_npz, tmp_path):
    path = tiny_npz[0]
    model = KeypointDetector(tconfig.tiny())
    params, stats, step = load_npz(str(path))
    assert step == 17
    assert params["per_point_pn"]["dense_2"]["kernel"].shape == (256, 8)
    assert set(stats) <= set(params)

    key = "params['per_point_pn']['dense_1']['bias']"
    missing = _rewrite(path, tmp_path / "missing.npz",
                       lambda a: a.pop(key))
    with pytest.raises(KeyError, match=r"dense_1'\]\['bias'\]"):
        load_detector_npz(model, missing)

    def drop_stack(a):
        for k in [k for k in a if "['node_a_pn']" in k]:
            a.pop(k)
    with pytest.raises(KeyError, match="node_a_pn.layers.0.conv.weight"):
        load_detector_npz(model, _rewrite(path, tmp_path / "stack.npz",
                                          drop_stack))

    kernel = "params['per_point_pn']['dense_2']['kernel']"
    shaped = _rewrite(path, tmp_path / "shape.npz",
                      lambda a: a.update({kernel: a[kernel][:, :5]}))
    with pytest.raises(ValueError, match="per_point_pn.layers.2.conv.weight"):
        load_detector_npz(model, shaped)

    bad = _rewrite(path, tmp_path / "bad.npz",
                   lambda a: a.update({"weights/dense": a["__step__"]}))
    with pytest.raises(ValueError, match="weights/dense"):
        load_npz(bad)
