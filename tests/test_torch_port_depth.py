"""The port's DepthNet (``models/depth.py``) against the JAX package's: on
the committed depth checkpoint and on seeded weights at small widths and
odd sizes; ``depth_loss``; the cosine schedule of ``train/depth_cli.py``
against optax's; the ``.npz`` round trip and the orbax refusal.  The
trainer and ``depth-dump`` are in ``test_torch_port_depth_train.py`` and
``test_torch_port_depth_dump.py``, which reuse this file's helpers."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.models.depth import DepthNet as JaxDepthNet
from deepi2p_tpu.models.depth import depth_loss as jax_depth_loss
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.models.depth import DepthNet, depth_loss
from deepi2p_tpu_torch.models.from_jax import depth_state_dict_from_flax
from deepi2p_tpu_torch.train import depth_cli
from deepi2p_tpu_torch.train.checkpoint import load_npz

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "ckpts" / "depth_kitti_160x512_dense"
SMALL = (4, 8, 8, 16)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_net(params, widths=(16, 32, 64, 128)):
    model = DepthNet(widths=widths)
    depth_cli.load_depth_state(model, depth_state_dict_from_flax(params))
    return model.eval()


def port_forward(model, img):
    with torch.no_grad():
        return model(torch.as_tensor(img)).numpy()


def jax_init(widths, img, seed=0):
    """A JAX DepthNet and a params tree of its structure
    (``jax.eval_shape``, no compile) filled by numpy: kernels LeCun-normal,
    GroupNorm scales about 1 and biases about 0, so every leaf's mapping
    shows."""
    model = JaxDepthNet(widths=widths)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(img)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if leaf == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def restore_committed():
    """The committed orbax checkpoint, restored as the JAX package's
    ``load_depth_fn`` does (template from ``jax.eval_shape``)."""
    import orbax.checkpoint as ocp
    model = JaxDepthNet()
    ex = np.zeros((1, 64, 96, 3), np.float32)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(ex)))
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    mgr = ocp.CheckpointManager(str(CKPT))
    params = mgr.restore(mgr.latest_step(),
                         args=ocp.args.StandardRestore(template))
    mgr.close()
    return model, jax.tree.map(np.asarray, params)


def test_committed_checkpoint_forward_matches_jax():
    """The committed DepthNet at 160x512, B=2, f32 on street images."""
    jmodel, params = restore_committed()
    cfg = jax_config.tiny(synthetic_scene="street", img_H=160, img_W=512,
                          input_pt_num=2048)
    img = jax_synthetic_batch(cfg, batch_size=2, seed=3)["img"]
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(img)))
    got = port_forward(port_net(params), img)
    assert got.shape == ref.shape == (2, 160, 512)
    assert rel(got, ref) < 1e-4
    # trained weights: the depth spans the scene, not a constant
    assert got.max() > 3 * got.min()


@pytest.mark.parametrize("hw", [(16, 24), (13, 19), (9, 31), (33, 50)])
def test_seeded_small_widths_odd_sizes(hw):
    """Odd sizes exercise SAME's (1, 1) against (0, 1) padding and the
    nearest-exact resize back to an odd skip."""
    rng = np.random.default_rng(hw[0])
    img = rng.uniform(0, 255, (2, *hw, 3)).astype(np.float32)
    jmodel, params = jax_init(SMALL, img, seed=hw[1])
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(img)))
    got = port_forward(port_net(params, SMALL), img)
    assert got.shape == ref.shape == (2, *hw)
    assert rel(got, ref) < 1e-5


def test_depth_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(1e-4, 90, (3, 17, 23)).astype(np.float32)
    gt = rng.uniform(1e-4, 90, (3, 17, 23)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.6] = 0
    ref = float(jax_depth_loss(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(depth_loss(torch.as_tensor(pred), torch.as_tensor(gt)))
    assert abs(got - ref) <= 1e-6 * abs(ref)
    zero = depth_loss(torch.ones(2, 3), torch.zeros(2, 3))
    assert float(zero) == 0.0


@pytest.mark.parametrize("lr,steps", [(3e-4, 2), (1e-3, 7), (3e-4, 2000)])
def test_cosine_schedule_matches_optax(lr, steps):
    sched = optax.cosine_decay_schedule(lr, steps)
    for count in sorted({0, 1, 2, steps // 2, steps - 1, steps, steps + 3}):
        ref = float(sched(jnp.asarray(count, jnp.int32)))
        got = depth_cli.cosine_decay_lr(lr, steps, count)
        assert abs(got - ref) <= 1e-7 * lr, (count, got, ref)


def test_npz_round_trip_is_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (1, 16, 24, 3)).astype(np.float32)
    _, params = jax_init(SMALL, img)
    model = port_net(params, SMALL)
    path = depth_cli.save_depth_params(model, str(tmp_path / "a"), step=5)
    assert os.path.basename(path) == "depth.npz"
    back = DepthNet(widths=SMALL)
    tree, stats, step = load_npz(path)
    assert step == 5 and not stats
    depth_cli.load_depth_state(back, depth_state_dict_from_flax(tree))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), k
    # written from the flax tree itself: the same file content
    path2 = depth_cli.save_depth_params(params, str(tmp_path / "b"), step=5)
    with np.load(path) as za, np.load(path2) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), k
        assert "params['enc0']['Conv_0']['kernel']" in za.files
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(za.files) - 1


def test_orbax_directory_is_refused():
    with pytest.raises(SystemExit, match="orbax depth checkpoints"):
        depth_cli.load_depth_fn(str(CKPT), config.tiny(), device="cpu")


