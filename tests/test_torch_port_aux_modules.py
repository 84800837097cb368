"""The library modules only tests use, against the JAX package's:
``ops/ball_query.py`` (exact indices), ``ops/som.py::query_topk``,
``ops/sampling.py::farthest_point_sample`` (bitwise, given JAX's first
index), ``models/extra_layers.py`` through ``from_jax`` (within 1e-4, TF32
off, eval and train mode with the running statistics),
``train/aux_losses.py`` (within 1e-5) and ``utils/profiling.py``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.models import extra_layers as jx
from deepi2p_tpu.ops.ball_query import ball_query as jax_ball_query
from deepi2p_tpu.ops.sampling import farthest_point_sample as jax_fps
from deepi2p_tpu.ops.som import query_topk as jax_query_topk
from deepi2p_tpu.train import aux_losses as jl
from deepi2p_tpu_torch.models import extra_layers as tx
from deepi2p_tpu_torch.models.from_jax import (extra_state_dict_from_flax,
                                               load_state_dict)
from deepi2p_tpu_torch.ops.ball_query import ball_query
from deepi2p_tpu_torch.ops.sampling import farthest_point_sample
from deepi2p_tpu_torch.ops.som import query_topk
from deepi2p_tpu_torch.train import aux_losses as tl
from deepi2p_tpu_torch.utils import profiling
from test_torch_port_train_parts import one_torch_thread  # noqa: F401

LAYER_TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("radius,k", [(0.3, 4), (1.0, 8), (2.5, 16),
                                      (0.05, 3)])
def test_ball_query_exact(radius, k):
    rng = np.random.default_rng(int(radius * 100) + k)
    dist = rng.uniform(0, 3, (2, 17, 40)).astype(np.float32)
    dist[0, 0] = 9.0                       # a row without hits
    got = ball_query(torch.as_tensor(dist), radius, k)
    want = np.asarray(jax_ball_query(jnp.asarray(dist), radius, k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_semantics():
    """``tests/test_aux.py::test_ball_query_semantics``: cyclic repetition,
    zeros without hits, the first k hits in index order."""
    dist = torch.tensor([[[0.5, 9.0, 0.2, 9.0], [9.0, 9.0, 9.0, 9.0],
                          [0.1, 0.2, 0.3, 0.4]]])
    idx = ball_query(dist, radius=1.0, k=3).numpy()
    np.testing.assert_array_equal(idx[0], [[0, 2, 0], [0, 0, 0], [0, 1, 2]])


def test_query_topk_matches_jax():
    rng = np.random.default_rng(0)
    B, N, M, k = 2, 50, 9, 3
    node = rng.normal(size=(B, M, 3)).astype(np.float32)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    got = query_topk(torch.as_tensor(node), torch.as_tensor(x), M, k)
    want = jax_query_topk(jnp.asarray(node), jnp.asarray(x), M, k)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("seed,D,k", [(0, 3, 16), (1, 2, 32), (2, 3, 64)])
def test_fps_bitwise_given_the_first_index(seed, D, k):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=5, size=(400, D)).astype(np.float32)
    pts[200:210] = pts[100]                 # ties: the first maximum wins
    want = np.asarray(jax_fps(jnp.asarray(pts), k,
                              jax.random.PRNGKey(seed)))
    got = farthest_point_sample(torch.as_tensor(pts), k, first=int(want[0]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # batched, and the first index from a generator
    both = farthest_point_sample(torch.as_tensor(np.stack([pts, pts])), k,
                                 first=torch.tensor([int(want[0])] * 2))
    np.testing.assert_array_equal(both.numpy(), np.stack([want, want]))
    g = farthest_point_sample(torch.as_tensor(pts), k,
                              torch.Generator().manual_seed(seed))
    assert len(set(g.tolist())) == k
    with pytest.raises(ValueError, match="generator"):
        farthest_point_sample(torch.as_tensor(pts), k)


def _port(port_module, flax_vars):
    sd = extra_state_dict_from_flax(flax_vars["params"],
                                    flax_vars.get("batch_stats"))
    load_state_dict(port_module, sd)
    return port_module


def _calibrate(vs, seed=0):
    """Random running statistics, so eval mode is not the identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.normal(scale=0.3, size=v.shape), v.dtype)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, v.shape), v.dtype)
        return v
    if "batch_stats" in vs:
        vs = dict(vs, batch_stats=jax.tree_util.tree_map_with_path(
            leaf, vs["batch_stats"]))
    return vs


def _close(got, want, tol=LAYER_TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _compare(flax_mod, port_mod, inputs, *, train_stats=True, outs=1):
    """Eval mode, then train mode (batch statistics) and the running
    statistics it leaves, port against flax."""
    jin = [jnp.asarray(x) for x in inputs]
    tin = [torch.as_tensor(x) for x in inputs]
    kw = {"train": False} if train_stats else {}
    vs = _calibrate(flax_mod.init(jax.random.PRNGKey(0), *jin, **kw))
    port = _port(port_mod, vs)
    port.eval()
    want = flax_mod.apply(vs, *jin, **kw)
    got = port(*tin)
    for g, w in zip(*(((got,), (want,)) if outs == 1 else (got, want))):
        _close(g, w)
    if not train_stats:
        return
    port.train()
    want, upd = flax_mod.apply(vs, *jin, train=True, mutable=["batch_stats"])
    got = port(*tin)
    for g, w in zip(*(((got,), (want,)) if outs == 1 else (got, want))):
        _close(g, w)
    if "batch_stats" in upd:
        sd = extra_state_dict_from_flax({}, upd["batch_stats"])
        own = port.state_dict()
        for name, v in sd.items():
            _close(own[name], v)


def test_emau(rng):
    x = rng.normal(size=(2, 20, 16)).astype(np.float32)
    for stage, normed in ((1, False), (3, True)):
        _compare(jx.EMAU(channels=16, bases=4, stage_num=stage,
                         is_normalized=normed),
                 tx.EMAU(16, 4, stage_num=stage, is_normalized=normed),
                 [x], outs=2)


@pytest.mark.parametrize("features", [[16, 16, 16, 32], [8, 12]])
def test_point_resnet(rng, features):
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    _compare(jx.PointResNet(features), tx.PointResNet(8, features), [x])


@pytest.mark.parametrize("final_pool,shape", [(False, (2, 10, 8)),
                                              (True, (2, 5, 4, 8))])
def test_pointnet_fusion(rng, final_pool, shape):
    x = rng.normal(size=shape).astype(np.float32)
    _compare(jx.PointNetFusion([16, 16], [32, 8], final_pool=final_pool,
                               activation="elu"),
             tx.PointNetFusion(8, [16, 16], [32, 8], final_pool=final_pool,
                               activation="elu"), [x])


@pytest.mark.parametrize("norm,act", [(None, None), ("batch", "relu"),
                                      ("instance", "leakyrelu")])
def test_upconv(rng, norm, act):
    img = rng.normal(size=(2, 6, 5, 4)).astype(np.float32)
    _compare(jx.UpConv(6, normalization=norm, activation=act),
             tx.UpConv(4, 6, normalization=norm, activation=act), [img])


@pytest.mark.parametrize("center", ["center", "avg"])
def test_knn_module(rng, center):
    coords = rng.normal(size=(2, 12, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 12, 8)).astype(np.float32)
    _compare(jx.KNNModule([16, 16], k=4, center_type=center),
             tx.KNNModule(8, [16, 16], k=4, center_type=center),
             [coords, feats], outs=2)


def test_knn_fusion_module(rng):
    coords = rng.normal(size=(2, 12, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 12, 8)).astype(np.float32)
    _compare(jx.KNNFusionModule([16, 16], [32, 16], k=4),
             tx.KNNFusionModule(8, [16, 16], [32, 16], k=4),
             [coords, feats], outs=2)


@pytest.mark.parametrize("order", [("conv", "norm", "act"),
                                   ("norm", "conv", "act"),
                                   ("act", "conv", "norm")])
def test_conv_module(rng, order):
    x = rng.normal(size=(1, 8, 7, 4)).astype(np.float32)
    _compare(jx.ConvModule(6, order=order, stride=2),
             tx.ConvModule(4, 6, order=order, stride=2), [x])


@pytest.mark.parametrize("padding", [1, "SAME", "VALID"])
def test_wsconv_and_scale(rng, padding):
    x = rng.normal(size=(1, 8, 7, 4)).astype(np.float32)
    kw = dict(kernel_size=(3, 3), padding=padding)
    _compare(jx.WSConv(features=6, **kw), tx.WSConv(4, 6, **kw), [x],
             train_stats=False)
    _compare(jx.Scale(init_value=2.5), tx.Scale(2.5), [x], train_stats=False)


def test_losses_match_jax(rng):
    a = rng.normal(size=(2, 10, 3)).astype(np.float32)
    b = rng.normal(size=(2, 14, 3)).astype(np.float32)
    sa = rng.uniform(0.5, 2.0, (2, 10)).astype(np.float32)
    sb = rng.uniform(0.5, 2.0, (2, 14)).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    _close(tl.gaussian_kernel_2d(5, 1.3), jl.gaussian_kernel_2d(5, 1.3),
           LOSS_TOL)
    img = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    _close(tl.gaussian_smooth(T(img), 5, 1.0), jl.gaussian_smooth(J(img), 5,
                                                                  1.0),
           LOSS_TOL)
    kp = rng.uniform(0, 15, (2, 4, 2)).astype(np.float32)
    kp[0, 0] = (3.5, 6.5)                   # half-way: rounds to even
    hm = rng.uniform(0, 0.1, (2, 16, 16, 1)).astype(np.float32)
    for g, w in zip(tl.heatmap_loss(T(hm), T(kp), 5),
                    jl.heatmap_loss(J(hm), J(kp), 5)):
        _close(g, w, LOSS_TOL)
    for g, w in zip(tl.chamfer_loss(T(a), T(b)), jl.chamfer_loss(J(a), J(b))):
        _close(g, w, LOSS_TOL)
    for g, w in zip(tl.chamfer_loss_prob(T(a), T(b), T(sa), T(sb)),
                    jl.chamfer_loss_prob(J(a), J(b), J(sa), J(sb))):
        _close(g, w, LOSS_TOL)
    _close(tl.keypoint_on_pc_loss(T(a[:, :4]), T(b)),
           jl.keypoint_on_pc_loss(J(a[:, :4]), J(b)), LOSS_TOL)
    off = np.array([[[0.1, 0.1], [3.0, 0.0], [0.5, -2.0]]], np.float32)
    _close(tl.img_keypoint_offset_norm_loss(T(off), 1.0, 1.0),
           jl.img_keypoint_offset_norm_loss(J(off), 1.0, 1.0), LOSS_TOL)


def test_profiling(tmp_path):
    profiling.reset()
    with profiling.span("port_region"):
        torch.ones(8).sum()
    assert profiling.span_table() == {}
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("port_region", step=3):
            with profiling.span("inner"):
                torch.ones(8).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
    table = profiling.span_table()
    assert table["port_region"].calls == table["inner"].tops == 1
    assert table["inner"].device_ms is None
    profiling.reset()
    assert profiling.span_table() == {}
