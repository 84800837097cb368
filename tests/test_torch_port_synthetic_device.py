"""The port's on-device synthetic batches (``data/synthetic_device.py``)
against the JAX package's ``synthetic_jax`` and the host generator: the
batch contract, the renderer on the same cloud, pose and intrinsics, and
the checks of ``tests/test_synthetic_jax.py`` at its thresholds (surface
mix, label statistics, ranges, ``img_render_n``, nuScenes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic_jax import _render as jax_render
from deepi2p_tpu.data.synthetic_jax import synthetic_batch_jax
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.data.synthetic_device import (
    _render, synthetic_batch_device, synthetic_stacked_device)
from deepi2p_tpu_torch.ops.projection import generate_labels
from test_torch_port_train_parts import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def cfg():
    return config.tiny(synthetic_scene="street")


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("scene", ["street", "uniform"])
@pytest.mark.parametrize("with_depth", [False, True])
def test_contract_matches_host_and_jax(scene, with_depth):
    cfg = config.tiny(synthetic_scene=scene)
    host = synthetic_batch(cfg, batch_size=2, seed=0, with_depth=with_depth)
    dev = synthetic_batch_device(cfg, gen(0), batch_size=2,
                                 with_depth=with_depth)
    jb = synthetic_batch_jax(jconfig.tiny(synthetic_scene=scene),
                             jax.random.PRNGKey(0), batch_size=2,
                             with_depth=with_depth)
    assert set(dev) == set(host) == set(jb)
    for k in host:
        assert tuple(dev[k].shape) == host[k].shape == jb[k].shape, k
        assert dev[k].dtype == torch.float32, k
        assert host[k].dtype == jb[k].dtype == np.float32, k
        assert dev[k].is_contiguous() and bool(torch.isfinite(dev[k]).all())


def test_same_generator_state_same_batch(cfg):
    a = synthetic_batch_device(cfg, gen(3), batch_size=2, with_depth=True)
    b = synthetic_batch_device(cfg, gen(3), batch_size=2, with_depth=True)
    c = synthetic_batch_device(cfg, gen(4), batch_size=2)
    for k in c:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["pc"], c["pc"])


def _cloud(seed, n=16384):
    """A cloud in front of the tiny camera, dense enough that many points
    share a pixel, with a pose and the tiny intrinsics."""
    rng = np.random.default_rng(seed)
    cfg = config.tiny()
    pc = np.stack([rng.uniform(-20, 20, n), rng.uniform(-6, 6, n),
                   rng.uniform(-5, 40, n)], -1).astype(np.float32)
    inten = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    yaw = rng.uniform(-0.3, 0.3)
    c, s = np.cos(yaw), np.sin(yaw)
    P = np.array([[c, 0, s, rng.uniform(-1, 1)], [0, 1, 0, 0.2],
                  [-s, 0, c, rng.uniform(-2, 2)]], np.float32)
    f = 0.6 * cfg.img_W
    K = np.array([[f, 0, cfg.img_W / 2], [0, f, cfg.img_H / 2], [0, 0, 1]],
                 np.float32)
    return pc, inten, P, K, cfg.img_H, cfg.img_W


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_matches_jax(seed):
    """The same cloud, pose and K: point-pixel masks equal on >= 99.9% of
    pixels, the channels within 1e-2 where both hold a point, the depth
    within 1e-6 relative."""
    pc, inten, P, K, H, W = _cloud(seed)
    img_j, depth_j = jax_render(jnp.asarray(pc), jnp.asarray(inten),
                                jnp.asarray(P), jnp.asarray(K), H, W,
                                jax.random.PRNGKey(0), True)
    img_t, depth_t = _render(*(torch.as_tensor(x[None])
                               for x in (pc, inten, P, K)), H, W, gen(0),
                             True)
    img_j, depth_j = np.asarray(img_j), np.asarray(depth_j)
    img_t, depth_t = img_t[0].numpy(), depth_t[0].numpy()
    mj, mt = img_j[..., 2] == 128.0, img_t[..., 2] == 128.0
    assert mt.sum() > 0.3 * mt.size              # a dense splat
    assert (mj == mt).mean() >= 0.999
    both = mj & mt
    for ch in (0, 1):
        np.testing.assert_allclose(img_t[..., ch][both], img_j[..., ch][both],
                                   atol=1e-2, rtol=0)
    np.testing.assert_allclose(depth_t[both], depth_j[both], rtol=1e-6)
    assert np.all(depth_t[~mt] == 0.0)
    noise = img_t[~mt]
    assert noise.min() >= 0.0 and noise.max() < 60.0


def test_scene_distribution_parity(cfg):
    """Surface mix and label statistics agree with the host generator and
    the JAX one (``test_synthetic_jax.py::test_scene_distribution_parity``)."""
    B = 8
    host = synthetic_batch(cfg, batch_size=B, seed=1)
    dev = {k: v.numpy() for k, v in
           synthetic_batch_device(cfg, gen(1), batch_size=B).items()}
    jb = {k: np.array(v) for k, v in synthetic_batch_jax(
        jconfig.tiny(synthetic_scene="street"), jax.random.PRNGKey(1),
        batch_size=B).items()}
    fracs = {}
    for name, bb in (("host", host), ("device", dev), ("jax", jb)):
        ground = np.abs(bb["pc"][..., 1] - 2.0) < 0.3
        assert 0.3 < ground.mean() < 0.5, (name, ground.mean())
        assert bb["intensity"].min() >= 0.0 and bb["intensity"].max() <= 1.0
        np.testing.assert_allclose(np.linalg.norm(bb["sn"], axis=-1), 1.0,
                                   atol=1e-4)
        lab = generate_labels(*(torch.as_tensor(bb[k])
                                for k in ("pc", "P", "K")),
                              cfg.img_H, cfg.img_W,
                              cfg.img_fine_resolution_scale)
        assert int(lab.fine_violations) == 0
        fracs[name] = float(lab.coarse.float().mean())
    assert abs(fracs["host"] - fracs["device"]) < 0.1, fracs
    assert abs(fracs["jax"] - fracs["device"]) < 0.1, fracs
    assert 0.02 < fracs["device"] < 0.6, fracs
    # the image: noise in [0, 60) where no point landed, the splat's
    # constant 128 in channel 2 where one did
    img = dev["img"]
    pts = img[..., 2] == 128.0
    assert 0 < pts.mean() < 1
    assert img[~pts].min() >= 0.0 and img[~pts].max() < 60.0
    assert img[pts][:, :2].min() >= 0.0 and img[pts][:, :2].max() <= 255.0


def test_stacked_and_freshness(cfg):
    st = synthetic_stacked_device(cfg, [gen(2)] * 3, batch_size=2)
    assert tuple(st["pc"].shape) == (3, 2, cfg.input_pt_num, 3)
    assert tuple(st["img"].shape) == (3, 2, cfg.img_H, cfg.img_W, 3)
    assert not torch.allclose(st["pc"][0], st["pc"][1])
    other = synthetic_stacked_device(cfg, [gen(9)] * 3, batch_size=2)
    assert not torch.allclose(st["pc"], other["pc"])


def test_uniform_scene_and_nuscenes_convention():
    """The uniform scene's ranges; nuScenes batches are in ENU, and their
    labels are those of the camera-convention cloud and pose they were
    made from (the convention change moves columns exactly)."""
    ucfg = config.tiny()
    b = synthetic_batch_device(ucfg, gen(0), batch_size=2)
    assert tuple(b["pc"].shape) == (2, ucfg.input_pt_num, 3)
    lo = torch.tensor([-30.0, -5.0, -10.0])
    hi = torch.tensor([30.0, 5.0, 40.0])
    assert bool(((b["pc"] >= lo) & (b["pc"] <= hi)).all())
    ncfg = config.nuscenes(input_pt_num=512, node_a_num=16, node_b_num=16,
                           k_ab=4, img_H=64, img_W=96,
                           synthetic_scene="street")
    nb = synthetic_batch_device(ncfg, gen(0), batch_size=2)
    lab = generate_labels(nb["pc"], nb["P"], nb["K"], ncfg.img_H, ncfg.img_W,
                          ncfg.img_fine_resolution_scale)
    assert float(lab.coarse.float().mean()) > 0.01
    # back to the camera convention: (x, y, z)_cam = (x, -z, y)_enu
    pc = nb["pc"]
    pc_cam = torch.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], -1)
    P = nb["P"]
    P_cam = torch.stack([P[..., 0], -P[..., 2], P[..., 1], P[..., 3]], -1)
    lab_cam = generate_labels(pc_cam, P_cam, nb["K"], ncfg.img_H,
                              ncfg.img_W, ncfg.img_fine_resolution_scale)
    assert torch.equal(lab.coarse, lab_cam.coarse)
    # the ground plane is at camera y = +2, ENU z = -2 before the pose
    ground = (torch.abs(pc[..., 2] + 2.0) < 0.3).float().mean()
    assert 0.3 < float(ground) < 0.5


def test_img_render_n_subset_density(cfg):
    """``img_render_n`` renders only the first rn (permuted) points: the
    same clouds, fewer point-pixels, exactly the pixels of a render of the
    truncated cloud; rn=0 is bitwise the unset default."""
    rn = cfg.input_pt_num // 4
    full = synthetic_batch_device(cfg, gen(4), batch_size=2)
    sub = synthetic_batch_device(cfg.replace(img_render_n=rn), gen(4),
                                 batch_size=2)
    assert torch.equal(full["pc"], sub["pc"])
    n_full = int((full["img"][..., 2] == 128.0).sum())
    n_sub = int((sub["img"][..., 2] == 128.0).sum())
    assert 0 < n_sub < n_full
    img_trunc, _ = _render(full["pc"][:, :rn], full["intensity"][:, :rn],
                           full["P"], full["K"], cfg.img_H, cfg.img_W,
                           gen(0), False)
    assert torch.equal(img_trunc[..., 2] == 128.0, sub["img"][..., 2] == 128.0)
    zero = synthetic_batch_device(cfg.replace(img_render_n=0), gen(4),
                                  batch_size=2)
    assert torch.equal(zero["img"], full["img"])
