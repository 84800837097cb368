"""The port's depth trainer (``train/depth_cli.py``) against the JAX
package's: two steps from the JAX init on the same synthetic batches,
each step's loss and the weights after them; and ``depth_cli.main`` for
two steps on the CPU."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.train import depth_cli as jax_depth_cli
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.models.depth import DepthNet
from deepi2p_tpu_torch.models.from_jax import (depth_state_dict_from_flax,
                                               flax_from_depth_state_dict)
from deepi2p_tpu_torch.train import depth_cli
from test_torch_port_depth import jax_init


def test_two_train_steps_from_the_jax_init(monkeypatch):
    """The JAX trainer's step function and the port's ``train_depth`` from
    one init (numpy-filled JAX params, put in place of the port's seeded
    weights) on the same synthetic batches: the loss of each step, and
    every weight after the second step (Adam at the cosine rate of count
    1)."""
    cfg_kw = dict(synthetic_scene="street", input_pt_num=512,
                  img_H=32, img_W=48)
    jcfg, cfg = jax_config.tiny(**cfg_kw), config.tiny(**cfg_kw)
    steps, bs, lr, seed = 2, 2, 3e-4, 0
    ex = jax_synthetic_batch(jcfg, batch_size=bs, seed=seed << 40,
                             with_depth=True, dense_depth=True)
    jmodel, init = jax_init((16, 32, 64, 128), ex["img"], seed=seed)
    params = jax.tree.map(jnp.asarray, init)
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))
    opt_state = tx.init(params)
    step_fn = jax_depth_cli.make_train_step(jmodel, tx)
    ref = []
    for i in range(steps):
        b = jax_synthetic_batch(jcfg, batch_size=bs, seed=(seed << 40) + 1 + i,
                                with_depth=True, dense_depth=True)
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(b["img"]),
                                          jnp.asarray(b["depth"]))
        ref.append(float(loss))

    def from_init(compute_dtype, seed, device):
        model = DepthNet(compute_dtype=compute_dtype)
        depth_cli.load_depth_state(model, depth_state_dict_from_flax(init))
        return model.to(device)
    monkeypatch.setattr(depth_cli, "build_depth_net", from_init)
    model, val, losses = depth_cli.train_depth(
        cfg, steps=steps, batch_size=bs, lr=lr, seed=seed, dense=True,
        eval_batches=1, device="cpu")
    assert len(losses) == steps and math.isfinite(val)
    for got, want in zip(losses, ref):
        assert abs(got - want) <= 1e-5 * abs(want), (losses, ref)
    # every leaf after both steps, and each leaf's move from the init
    moved = flax_from_depth_state_dict(model.state_dict())
    want = jax.tree.map(np.asarray, params)
    flat_got = jax.tree_util.tree_flatten_with_path(moved)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_init = dict(jax.tree_util.tree_flatten_with_path(init)[0])
    assert len(flat_got) == len(flat_want)
    for path, got in flat_got:
        w, w0 = flat_want[path], flat_init[path]
        name = jax.tree_util.keystr(path)
        assert np.linalg.norm(got - w) <= 1e-5 * np.linalg.norm(w), name
        step = w - w0
        assert np.linalg.norm((got - w0) - step) <= \
            1e-3 * np.linalg.norm(step), name


def test_depth_cli_main_two_steps_on_cpu(tmp_path, capsys):
    val = depth_cli.main(["--steps", "2", "--batch-size", "2",
                          "--points", "512", "--img-h", "32", "--img-w", "48",
                          "--dense-targets", "--checkpoints-dir",
                          str(tmp_path / "d"), "--device", "cpu"])
    assert math.isfinite(val)
    assert "saved depth checkpoint" in capsys.readouterr().out
    fn = depth_cli.load_depth_fn(str(tmp_path / "d"), config.tiny(),
                                 device="cpu")
    depth = fn(np.full((32, 48, 3), 128, np.float32))
    assert depth.shape == (32, 48) and np.isfinite(depth).all()
