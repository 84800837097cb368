"""The training parts of the port against the JAX package on the CPU:
the loss and its metrics (``train/loss.py``), train-mode batch norm
against flax's ``BatchNorm`` (outputs, input gradient, running
statistics), the vjp of ``node_pool_max`` and ``scatter_to_points``
against ``jax.vjp`` (tied maxima in bf16), the head's dropout, and a
few train steps of the port alone."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from deepi2p_tpu.ops import segment as jseg
from deepi2p_tpu.ops.projection import Labels as JaxLabels
from deepi2p_tpu.train.loss import classification_loss as jax_loss
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.models import INPUT_KEYS, build_detector
from deepi2p_tpu_torch.models.layers import Norm, dropout
from deepi2p_tpu_torch.ops import segment as tseg
from deepi2p_tpu_torch.ops.projection import Labels
from deepi2p_tpu_torch.train.engine import Engine
from deepi2p_tpu_torch.train.loss import classification_loss

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread in this module: the suite runs several worker
    processes on the machine's cores, and PyTorch's default of one
    thread per core oversubscribes them (training steps then run ~20x
    slower than on one core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("inside_weight", [1.0, 3.0])
@pytest.mark.parametrize("fine", [True, False], ids=["fine", "coarse_only"])
def test_loss_and_metrics_match_jax(inside_weight, fine):
    """Loss, every metric and the gradients of the loss with respect to
    both logits, on logits spread wide enough that the focal loss's
    epsilons matter (softmax probabilities below 1e-6)."""
    rng = np.random.default_rng(int(inside_weight * 10) + fine)
    B, N, L = 2, 300, 6
    coarse = (rng.normal(size=(B, N, 2)) * 8).astype(np.float32)
    fine_l = (rng.normal(size=(B, N, L)) * 3).astype(np.float32)
    lc = rng.integers(0, 2, (B, N)).astype(np.int32)
    lf = rng.integers(0, L, (B, N)).astype(np.int32)

    def jf(c, f):
        lab = JaxLabels(coarse=jnp.asarray(lc), fine=jnp.asarray(lf),
                        pxpy=None, z=None, fine_violations=None)
        return jax_loss(c, f if fine else None, lab, coarse_loss_alpha=50.0,
                        inside_weight=inside_weight)
    (gc, gf), want = jax.grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(coarse), jnp.asarray(fine_l))
    ct = torch.from_numpy(coarse).requires_grad_()
    ft = torch.from_numpy(fine_l).requires_grad_()
    lab = Labels(coarse=torch.from_numpy(lc), fine=torch.from_numpy(lf),
                 pxpy=None, z=None, fine_violations=None)
    loss, got = classification_loss(ct, ft if fine else None, lab,
                                    coarse_loss_alpha=50.0,
                                    inside_weight=inside_weight)
    loss.backward()
    assert set(got) == set(want)
    assert ("fine" in got) == fine
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(want["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc),
                               rtol=1e-5, atol=1e-7)
    if fine:
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gf),
                                   rtol=1e-5, atol=1e-7)
    else:
        assert ft.grad is None


NORM_CASES = {
    "points": ((2, 300, 16), -1, torch.float32),
    "neighbourhoods": ((2, 20, 4, 16), -1, torch.float32),
    "nchw": ((2, 16, 6, 10), 1, torch.float32),
    "points_bf16": ((2, 300, 16), -1, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_train_mode_norm_matches_flax_batchnorm(case):
    """Output, input gradient, scale and offset gradients, and the
    running statistics after one update (momentum 0.1: flax's 0.9),
    against ``flax.linen.BatchNorm`` in train mode on the same input
    (NCHW maps go to flax as NHWC).  f32 within 1e-5; the bf16 output
    within one bf16 rounding (statistics and gradients in f32 on both
    sides)."""
    shape, axis, dtype = NORM_CASES[case]
    rng = np.random.default_rng(len(shape))
    C = shape[axis]
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.1, C).astype(np.float32)
    mean0 = rng.normal(0, 0.1, C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to_flax = (lambda a: np.moveaxis(a, 1, -1)) if axis == 1 else (
        lambda a: a)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jdt)

    def f(x, p):
        y, upd = bn.apply({"params": p, "batch_stats": {"mean": mean0,
                                                         "var": var0}},
                          x, mutable=["batch_stats"])
        return jnp.sum(jax.nn.relu(y.astype(jnp.float32)) * to_flax(w)), (
            y, upd["batch_stats"])
    (gx, gp), (y, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(to_flax(x)).astype(jdt), {"scale": scale, "bias": bias})

    norm = Norm(C, "batch", channel_axis=axis).train()
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        norm.running_mean.copy_(torch.from_numpy(mean0))
        norm.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    yt = norm(xt)
    assert yt.dtype == dtype
    (torch.relu(yt.float()) * torch.from_numpy(w)).sum().backward()

    tol = dict(rtol=2 ** -8, atol=2 ** -8) if dtype == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_flax(yt.detach().float().numpy()),
                               np.asarray(y.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)
    if dtype == torch.float32:
        np.testing.assert_allclose(to_flax(xt.grad.numpy()), np.asarray(gx),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(norm.weight.grad.numpy(),
                                   np.asarray(gp["scale"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(norm.bias.grad.numpy(),
                                   np.asarray(gp["bias"]), rtol=1e-5,
                                   atol=1e-5)
    # the batch statistics, not the running ones, normalised the input
    assert not np.allclose(norm.running_mean.numpy(), mean0)


def _tied_features(dtype):
    """(B, N, C) features over 5 nodes of batch 0 and 5 of batch 1 (node
    4 of batch 0 empty), each node's maximum repeated 1, 2 or 4 times in
    some channels; cotangents are small integers, exact in bf16."""
    rng = np.random.default_rng(3)
    B, N, M, C = 2, 64, 5, 6
    idx = rng.integers(0, M, (B, N)).astype(np.int32)
    idx[0][idx[0] == 4] = 3
    f = np.round(rng.normal(size=(B, N, C)) * 8) / 8
    for b in range(B):
        for m in range(M):
            pts = np.flatnonzero(idx[b] == m)
            for c, reps in zip(range(C), (1, 2, 4, 2, 1, 4)):
                if len(pts) >= reps:
                    f[b, pts[:reps], c] = 5.0 + m
    cot = rng.integers(-3, 4, (B, M, C)).astype(np.float32) * 4
    return f.astype(np.float32), idx, M, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_node_pool_max_vjp_matches_jax_with_ties(dtype):
    """The port's ``scatter_reduce(amax)`` backward and the JAX
    ``segment_max`` vjp both split a tied maximum's cotangent equally:
    equal gradients, bitwise (ties of 1, 2 and 4; an empty node)."""
    f, idx, M, cot = _tied_features(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (pooled_j, _), vjp = jax.vjp(
        lambda x: jseg.node_pool_max(x, jnp.asarray(idx), M),
        jnp.asarray(f).astype(jdt))
    (g_j,) = vjp((jnp.asarray(cot).astype(jdt),
                  jnp.zeros((f.shape[0], M), jdt)))
    ft = torch.from_numpy(f).to(tdt).requires_grad_()
    pooled_t, _ = tseg.node_pool_max(ft, torch.from_numpy(idx), M)
    pooled_t.backward(torch.from_numpy(cot).to(tdt))
    np.testing.assert_array_equal(
        pooled_t.detach().float().numpy(),
        np.asarray(pooled_j.astype(jnp.float32)))
    g_t = ft.grad.float().numpy()
    np.testing.assert_array_equal(g_t, np.asarray(g_j.astype(jnp.float32)))
    assert np.any((g_t != 0) & (np.abs(g_t) < np.abs(cot).max())), \
        "no split cotangent: the ties were not exercised"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_to_points_vjp_matches_jax(dtype):
    """Node features gathered back to points: the vjp sums each point's
    cotangent into its node, equal to the JAX one-hot einsum's vjp
    (small-integer cotangents, so every sum is exact in bf16)."""
    f, idx, M, _ = _tied_features(dtype)
    rng = np.random.default_rng(4)
    nodes = rng.normal(size=(f.shape[0], M, f.shape[2])).astype(np.float32)
    cot = rng.integers(-3, 4, f.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out_j, vjp = jax.vjp(lambda x: jseg.scatter_to_points(x, jnp.asarray(idx)),
                         jnp.asarray(nodes).astype(jdt))
    (g_j,) = vjp(jnp.asarray(cot).astype(jdt))
    nt = torch.from_numpy(nodes).to(tdt).requires_grad_()
    out_t = tseg.scatter_to_points(nt, torch.from_numpy(idx))
    out_t.backward(torch.from_numpy(cot).to(tdt))
    np.testing.assert_array_equal(out_t.detach().float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
    np.testing.assert_array_equal(nt.grad.float().numpy(),
                                  np.asarray(g_j.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_rate_scale_and_seed(dtype):
    """flax's dropout: a fraction ``rate`` zeroed (binomial, 6 sigma),
    the rest scaled by exactly ``1 / (1 - rate)`` in the input's dtype;
    one generator seed gives one mask, another seed another; no
    generator raises."""
    x = torch.full((64, 1000), 1.5, dtype=dtype)
    y = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert y.dtype == dtype
    assert set(torch.unique(y).tolist()) == {0.0, 3.0}
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.5) < 6 * np.sqrt(0.25 / x.numel())
    y2 = dropout(x, 0.5, torch.Generator().manual_seed(1))
    y3 = dropout(x, 0.5, torch.Generator().manual_seed(2))
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    y4 = dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert abs(float((y4 != 0).float().mean()) - 0.75) < 0.01
    assert set(torch.unique(y4).tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)


def test_head_dropout_only_in_train_mode():
    """The head's rates are [0.5, 0.5, 0]: in eval mode the forward
    ignores the generator; in train mode two seeds give two outputs, one
    seed twice the same, and a forward without a generator raises."""
    cfg = tconfig.tiny()
    model = build_detector(cfg, device="cpu", seed=0)
    rates = [layer.dropout_rate for layer in model.per_point_pn.layers]
    assert rates == [0.5, 0.5, 0.0]
    batch = synthetic_batch(cfg, seed=0)
    inputs = [torch.from_numpy(batch[k]) for k in INPUT_KEYS]
    with torch.no_grad():
        a = model.eval()(*inputs)[0]
        b = model(*inputs, generator=torch.Generator().manual_seed(9))[0]
        assert torch.equal(a, b)
        model.train()
        t1 = model(*inputs, generator=torch.Generator().manual_seed(1))[0]
        t1b = model(*inputs, generator=torch.Generator().manual_seed(1))[0]
        t2 = model(*inputs, generator=torch.Generator().manual_seed(2))[0]
        assert torch.equal(t1, t1b) and not torch.equal(t1, t2)
        with pytest.raises(ValueError, match="Generator"):
            model(*inputs)


def test_train_steps_lower_the_loss_and_reach_every_parameter():
    """Eight steps on one repeated batch lower the loss (as
    ``tests/test_train.py:101``); every parameter gets a finite gradient
    that is not identically zero (``:187``); dropout on."""
    cfg = tconfig.tiny()
    engine = Engine(cfg, steps_per_epoch=100, device="cpu")
    state = engine.init_state(seed=0)

    batch = synthetic_batch(cfg, seed=1)
    gen = torch.Generator().manual_seed(3)
    _, _, grads = engine.loss_and_grads(copy.deepcopy(state), batch, gen)
    names = [n for n, _ in state.model.named_parameters()]
    assert len(grads) == len(names)
    dead = [n for n, g in zip(names, grads) if not bool(torch.any(g != 0))]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not dead, dead
    losses = []
    for _ in range(8):
        state, m = engine.train_step(state, batch, gen)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)) and state.step == 8
    assert losses[-1] < losses[0], losses
    ev = engine.eval_step(state, batch)
    assert np.isfinite(float(ev["loss"]))
    coarse, fine = engine.infer(state, batch)
    assert coarse.shape == fine.shape == (cfg.batch_size, cfg.input_pt_num)
