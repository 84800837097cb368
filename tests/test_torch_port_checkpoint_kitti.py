"""The committed ``ckpts/kitti_shape_r4/latest.npz`` (step 32768) through
the port's loader, held to the JAX forward at ``config.kitti()`` width
(128 nodes, 160x512, its trained N=8192, B=1) at the argmax agreement
rates stated, in f32 and in the production bf16."""
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
from deepi2p_tpu.train.checkpoint import warm_start_npz
from deepi2p_tpu.train.engine import TrainState
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.models import INPUT_KEYS, KeypointDetector
from deepi2p_tpu_torch.train.checkpoint import load_detector_npz

from test_torch_port_checkpoint import interpret_knn

CKPT = Path(__file__).resolve().parents[1] / "ckpts/kitti_shape_r4/latest.npz"


@pytest.mark.parametrize("dtype,coarse_rate,fine_rate", [
    ("float32", 0.999, 0.999),
    ("bfloat16", 0.99, 0.95),
])
def test_committed_checkpoint_matches_jax_forward(dtype, coarse_rate,
                                                   fine_rate):
    """``ckpts/kitti_shape_r4/latest.npz`` (step 32768) at its trained
    shape: the JAX side reads it with its own ``warm_start_npz``, the port
    with ``load_detector_npz``; one street sample of the JAX dump CLI's
    dataset seed.  The rates are argmax agreement over the N points."""
    kw = dict(input_pt_num=8192, batch_size=1, synthetic_scene="street",
              compute_dtype=dtype)
    jcfg = jconfig.kitti(**kw)
    batch = jax_synthetic_batch(jcfg, seed=7 << 40)
    inputs = [jnp.asarray(batch[k]) for k in INPUT_KEYS]
    jmodel = JaxDetector(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *inputs, train=False))
    template = TrainState(step=None, params=shapes["params"],
                          batch_stats=shapes["batch_stats"], opt_state=None)
    state = warm_start_npz(template, str(CKPT), optax.adam(1e-3))
    with interpret_knn():
        cj, fj = jmodel.apply({"params": state.params,
                               "batch_stats": state.batch_stats}, *inputs,
                              train=False)
    model = KeypointDetector(tconfig.kitti(**kw)).eval()
    assert load_detector_npz(model, str(CKPT)) == 32768
    with torch.no_grad():
        ct, ft = model(*(torch.from_numpy(batch[k]) for k in INPUT_KEYS))
    assert ft.shape == (1, 8192, 80)
    coarse = np.mean(ct.numpy().argmax(-1) == np.asarray(cj).argmax(-1))
    fine = np.mean(ft.numpy().argmax(-1) == np.asarray(fj).argmax(-1))
    print(f"{dtype}: coarse argmax agreement {coarse:.5f}, fine {fine:.5f}")
    assert coarse >= coarse_rate and fine >= fine_rate, (coarse, fine)
