"""The port's ``KeypointDetector`` against the JAX package's, with the same
weights: flax init -> ``export_torch_detector`` / the port's ``from_jax``
bridge -> the port, on the same synthetic batch, in f32 on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.models import KeypointDetector as JaxDetector
from deepi2p_tpu.ops import knn_pallas as jax_knn_pallas
from deepi2p_tpu.models.torch_import import export_torch_detector
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.models import (KeypointDetector, load_state_dict,
                                      state_dict_from_flax)

KEYS = ("pc", "intensity", "sn", "node_a", "node_b", "img")


def _randomize(tree, rng):
    """Non-trivial norm scales and biases, so that every mapped tensor
    changes the output."""
    def leaf(path, x):
        name = path[-1].key
        x = np.array(x, np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _calibrated_stats(jmodel, params, stats0, inputs, key):
    """Running means equal to this batch's own and running variances one
    above its own (one train-mode pass; flax keeps ``0.9 * old + 0.1 *
    batch``).

    Random weights with identity statistics let activations grow layer by
    layer to logits of ~1e7, where an absolute tolerance means nothing.
    Batch variances alone normalise every layer, but a channel whose
    variance over the tiny maps (2x3 at stride 32) is near zero then
    amplifies f32 rounding: measured, both frameworks land ~4e-4 from a
    float64 run of the same network.  The unit floor keeps the logits
    O(1) and the network well conditioned, so 1e-4 tests the port."""
    _, upd = jmodel.apply({"params": params, "batch_stats": stats0}, *inputs,
                          train=True, mutable=["batch_stats"],
                          rngs={"dropout": key})

    def leaf(path, new, old):
        batch = (np.asarray(new) - 0.9 * old) / 0.1
        return batch + 1.0 if path[-1].key == "var" else batch
    return jax.tree_util.tree_map_with_path(leaf, upd["batch_stats"], stats0)


def _both(cfg_kw, seed):
    """On the TPU the JAX forward's kNN is the Pallas kernel (direct
    differences); on the CPU it would take the |x|^2+|y|^2-2xy XLA path,
    whose cancellation moves the distances of points that coincide with
    a node.  So the JAX side runs the Pallas kernel in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_knn_pallas, "pallas_eligible", lambda q, db, k: True)
        mp.setattr(jax_knn_pallas, "knn_pallas", functools.partial(
            jax_knn_pallas.knn_pallas, interpret=True))
        return _both_inner(cfg_kw, seed)


def _both_inner(cfg_kw, seed):
    jcfg = jconfig.oxford(**cfg_kw) if "input_pt_num" in cfg_kw else \
        jconfig.tiny(**cfg_kw)
    batch = jax_synthetic_batch(jcfg, seed=seed)
    jmodel = JaxDetector(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            *(jnp.asarray(batch[k]) for k in KEYS),
                            train=False)
    rng = np.random.default_rng(seed)
    inputs = [jnp.asarray(batch[k]) for k in KEYS]
    params = _randomize(variables["params"], rng)
    stats0 = jax.tree.map(lambda x: np.array(x, np.float32),
                          variables["batch_stats"])
    stats = _calibrated_stats(jmodel, params, stats0, inputs,
                              jax.random.PRNGKey(seed + 1))
    coarse_j, fine_j = jmodel.apply({"params": params, "batch_stats": stats},
                                    *inputs, train=False)
    tcfg = (tconfig.oxford(**cfg_kw) if "input_pt_num" in cfg_kw
            else tconfig.tiny(**cfg_kw))
    model = KeypointDetector(tcfg).eval()
    load_state_dict(model, state_dict_from_flax(params, stats))
    with torch.no_grad():
        coarse_t, fine_t = model(*(torch.from_numpy(batch[k]) for k in KEYS))
    return (params, stats, batch, model, np.asarray(coarse_j),
            np.asarray(fine_j), coarse_t.numpy(), fine_t.numpy())


@pytest.fixture(scope="module")
def tiny():
    return _both({}, seed=0)


def test_tiny_logits_match_jax(tiny):
    *_, cj, fj, ct, ft = tiny
    assert ct.shape == cj.shape and ft.shape == fj.shape
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)


def test_bridge_matches_export_torch_detector(tiny):
    """The port's own name mapping gives the state_dict that the JAX
    package's exporter writes (its Linear weights carry a trailing
    Conv1d axis), and both load to the same model output."""
    params, stats, batch, model, *_, ct, ft = tiny
    ours = state_dict_from_flax(params, stats)
    theirs = export_torch_detector(params, stats)
    assert set(ours) == set(theirs) == set(model.state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v).reshape(ours[k].shape),
                                      ours[k])
    knn_w = theirs["pc_encoder.knnlayer.layers_before.0.conv.weight"]
    assert knn_w.ndim == 3 and knn_w.shape[-1] == 1
    other = KeypointDetector(tconfig.tiny()).eval()
    load_state_dict(other, theirs)
    with torch.no_grad():
        c2, f2 = other(*(torch.from_numpy(batch[k]) for k in KEYS))
    np.testing.assert_array_equal(c2.numpy(), ct)
    np.testing.assert_array_equal(f2.numpy(), ft)


def test_load_state_dict_is_strict(tiny):
    params, stats, _, model, *_ = tiny
    sd = state_dict_from_flax(params, stats)
    sd.pop("node_a_pn.layers.0.conv.bias")
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(model, sd)


def test_oxford_widths_argmax_agrees():
    """Oxford channel and node widths, image 384x640, N cut to 2048, B=1."""
    *_, cj, fj, ct, ft = _both(dict(input_pt_num=2048, batch_size=1,
                                    compute_dtype="float32"), seed=1)
    assert ct.shape == (1, 2048, 2) and ft.shape == (1, 2048, 240)
    agree = np.mean(ct.argmax(-1) == cj.argmax(-1))
    assert agree >= 0.999, agree
    assert np.mean(ft.argmax(-1) == fj.argmax(-1)) >= 0.999
