"""The port's small parts against the JAX package's: node pooling,
interpolation, the config and the synthetic data."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.ops import interpolate as jinterp
from deepi2p_tpu.ops import segment as jseg
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
from deepi2p_tpu_torch.ops import interpolate as tinterp
from deepi2p_tpu_torch.ops import segment as tseg


def _assign(rng, B, N, M):
    idx = rng.integers(0, M - 1, (B, N)).astype(np.int32)   # node M-1 empty
    return idx


def test_node_mean_and_count_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 200, 3)).astype(np.float32)
    idx = _assign(rng, 2, 200, 16)
    m_j, c_j = jseg.node_mean_and_count(jnp.asarray(pts), jnp.asarray(idx), 16)
    m_t, c_t = tseg.node_mean_and_count(torch.from_numpy(pts),
                                        torch.from_numpy(idx), 16)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t[:, 15].sum() == 0 and (m_t[:, 15] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_node_pool_max_matches_jax_with_empty_node(dtype):
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 200, 8)).astype(np.float32)
    feat[:, :, 0] = -5.0 - rng.random((2, 200))     # all-negative channel
    idx = _assign(rng, 2, 200, 16)
    jd = jnp.dtype(dtype)
    p_j, h_j = jseg.node_pool_max(jnp.asarray(feat).astype(jd),
                                  jnp.asarray(idx), 16)
    p_t, h_t = tseg.node_pool_max(
        torch.from_numpy(feat).to(getattr(torch, dtype)),
        torch.from_numpy(idx), 16)
    assert p_t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(p_t.float().numpy(),
                                  np.asarray(p_j.astype(jnp.float32)))
    np.testing.assert_array_equal(h_t.float().numpy(),
                                  np.asarray(h_j.astype(jnp.float32)))
    assert (p_t[:, 15] == 0).all()


def test_scatter_to_points_matches_jax():
    rng = np.random.default_rng(2)
    nodes = rng.normal(size=(2, 16, 5)).astype(np.float32)
    idx = _assign(rng, 2, 100, 16)
    np.testing.assert_array_equal(
        tseg.scatter_to_points(torch.from_numpy(nodes),
                               torch.from_numpy(idx)).numpy(),
        np.asarray(jseg.scatter_to_points(jnp.asarray(nodes),
                                          jnp.asarray(idx))))


@pytest.mark.parametrize("with_d2", [True, False])
def test_interpolate_matches_jax_with_duplicate_indices(with_d2):
    rng = np.random.default_rng(3)
    B, N, M, C, k = 2, 64, 16, 7, 3
    q = rng.normal(size=(B, N, 3)).astype(np.float32)
    db = rng.normal(size=(B, M, 3)).astype(np.float32)
    q[0, 0] = db[0, 4]                                 # on a node: d = 0
    feat = rng.normal(size=(B, M, C)).astype(np.float32)
    idx = rng.integers(0, M, (B, N, k)).astype(np.int32)
    idx[:, :8, 1] = idx[:, :8, 0]                      # duplicate indices
    idx[0, 0] = [4, 4, 4]
    d2 = ((q[:, :, None, :] - np.take_along_axis(
        db[:, None, :, :], idx[..., None].astype(np.int64), axis=2)) ** 2
          ).sum(-1).astype(np.float32)
    out_j = jinterp.interpolate_inverse_dist(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(feat), jnp.asarray(idx),
        dist2=jnp.asarray(d2) if with_d2 else None)
    out_t = tinterp.interpolate_inverse_dist(
        torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(feat),
        torch.from_numpy(idx),
        dist2=torch.from_numpy(d2) if with_d2 else None)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    # the 1 - d/sum(d) weights sum to k - 1 = 2
    ones = tinterp.interpolate_inverse_dist(
        torch.from_numpy(q), torch.from_numpy(db), torch.ones(B, M, 1),
        torch.from_numpy(idx), dist2=torch.from_numpy(d2))
    np.testing.assert_allclose(ones.numpy(), 2.0, atol=1e-5)


def test_config_fields_and_presets_match_jax():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(
        jconfig.Config)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(
        tconfig.Config)]
    assert tf == jf
    for name in ("oxford", "kitti", "nuscenes", "tiny"):
        j = getattr(jconfig, name)()
        t = getattr(tconfig, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for prop in ("H_fine_res", "W_fine_res", "num_fine_classes",
                     "fine_out_channels"):
            assert getattr(t, prop) == getattr(j, prop)
    assert tconfig.oxford(batch_size=32).batch_size == 32


@pytest.mark.parametrize("preset,kw", [
    ("tiny", {}),
    ("tiny", dict(synthetic_scene="street")),
    ("nuscenes", dict(input_pt_num=512, batch_size=2)),
    ("oxford", dict(input_pt_num=1024, batch_size=1, img_render_n=256)),
])
def test_synthetic_batch_same_arrays(preset, kw):
    j = jax_synthetic_batch(getattr(jconfig, preset)(**kw), seed=7,
                            with_depth=True)
    t = synthetic_batch(getattr(tconfig, preset)(**kw), seed=7,
                        with_depth=True)
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_synthetic_dense_depth_same_arrays():
    cfg_kw = dict(synthetic_scene="street")
    j = jax_synthetic_batch(jconfig.tiny(**cfg_kw), seed=1, with_depth=True,
                            dense_depth=True)
    t = synthetic_batch(tconfig.tiny(**cfg_kw), seed=1, with_depth=True,
                        dense_depth=True)
    np.testing.assert_array_equal(t["depth"], j["depth"])


def test_batch_to_torch_on_cpu():
    b = batch_to_torch(synthetic_batch(tconfig.tiny(), seed=0), device="cpu")
    assert b["pc"].dtype == torch.float32 and b["pc"].shape == (2, 256, 3)


@pytest.mark.parametrize("normalization", ["batch", "instance"])
@pytest.mark.parametrize("activation",
                         ["relu", "elu", "swish", "leakyrelu", "selu"])
def test_pointnet_mlp_matches_jax(normalization, activation):
    """PointNetMLP with either norm and each activation, on point and
    neighbourhood (4-D) inputs, weights through the port's bridge."""
    from deepi2p_tpu.models.layers import PointNetMLP as JaxMLP
    from deepi2p_tpu_torch.models.from_jax import stack_state_dict
    from deepi2p_tpu_torch.models.layers import PointNetMLP
    rng = np.random.default_rng(len(normalization) + len(activation))
    x = rng.normal(size=(2, 6, 5, 9)).astype(np.float32)
    jm = JaxMLP([16, 12, 8], normalization=normalization,
                activation=activation, norm_act_at_last=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32), variables["params"])
    stats = jax.tree.map(lambda a: np.abs(np.asarray(a)) + rng.uniform(
        0.5, 1.5, a.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x)))
    tm = PointNetMLP(9, [16, 12, 8], normalization=normalization,
                     activation=activation, norm_act_at_last=True)
    sd = stack_state_dict(params, stats, "layers")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
