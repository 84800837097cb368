"""The 2-D frustum solve never returns a non-finite pose for a pair with an
inside label.

The constructed pair: its inside-labelled points lie at the solver's
stride but not at the probe's, so every point of the probe launch is
labelled outside, and one of them sits exactly on the camera plane of
some inits (p2 = 0).  Its 0 * inf makes those inits' H NaN, hence their
first step NaN; a NaN theta scores 0 where every point is labelled
outside, so an LM that takes any step that lowers the cost took it, the
NaN inits ranked first and the refine handed the pick a NaN.  This file
imports no JAX, so its card tests run on the card's machine too."""
import math

import numpy as np
import pytest
import torch

from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.register.frustum_cuda import (lm_solve_cuda,
                                                     lm_solve_plain)
from portbench.reference import frustum as ref

H, W = 64, 128
N, I = 256, 32
NAN_INITS = 8             # inits whose camera plane holds point 0
T_LB, T_UB = (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0)
SOLVE = dict(H=H, W=W, max_iter=24, solver_stride=2)


def constructed_pair():
    """(pc (1, N, 3), labels (1, N), K (1, 3, 3), theta0 (1, I, 4))."""
    rng = np.random.default_rng(0)
    # outside-labelled points behind the camera near its axis: out of view
    # at the identity, in view once the camera backs off by 2 m
    pc = np.stack([rng.uniform(-0.3, 0.3, N), rng.uniform(-0.2, 0.2, N),
                   rng.uniform(-1.9, -0.5, N)], -1).astype(np.float32)
    lab = np.zeros(N, np.float32)
    # six inside-labelled points in front, at indices 2 mod 4: in the
    # solver's points (stride 2), none in the probe's (stride 2 of those)
    ins = np.arange(2, N, 4)[:6]
    pc[ins] = np.stack([rng.uniform(-3, 3, 6), rng.uniform(-1, 1, 6),
                        rng.uniform(8, 20, 6)], -1)
    lab[ins] = 1.0
    # a probe point on the camera plane of the inits [0, 0, 0, 2]
    pc[0] = (0.5, 0.0, -2.0)
    f = 0.6 * W
    K = torch.tensor([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]])
    th0 = torch.zeros(1, I, 4)
    th0[0, :, 0] = torch.linspace(-0.2, 0.2, I)
    th0[0, :, 3] = torch.linspace(-3, 3, I)
    th0[0, :NAN_INITS, 0] = 0.0
    th0[0, :NAN_INITS, 3] = 2.0
    return torch.from_numpy(pc)[None], torch.from_numpy(lab)[None], K, th0


def probe_inputs(pc, lab):
    """The probe launch's points, labels and valid flags (strides 2, 2)."""
    _, valid = tf.initial_guess(pc, lab)
    return tuple(x[:, ::2][:, ::2].contiguous() for x in (pc, lab, valid))


def test_the_pair_is_as_constructed():
    pc, lab, K, th0 = constructed_pair()
    pts, labels, _ = probe_inputs(pc, lab)
    assert labels.sum() == 0 and lab[:, ::2].sum() == 6
    c, s = math.cos(0.0), math.sin(0.0)
    p2 = -s * pts[0, 0, 0] + c * pts[0, 0, 2] + th0[0, 0, 3]
    assert p2 == 0.0


def test_probe_never_steps_to_a_non_finite_theta():
    """The probe's NaN inits keep their init and its finite cost (the LM
    rejects the NaN step, whose cost is NaN); the others are as before."""
    pc, lab, K, th0 = constructed_pair()
    th, cost = lm_solve_plain(*probe_inputs(pc, lab), K, th0, T_LB, T_UB,
                              H=H, W=W, max_iter=8)
    assert torch.isfinite(th).all() and torch.isfinite(cost).all()
    assert torch.equal(th[0, :NAN_INITS], th0[0, :NAN_INITS])
    assert (cost[0, :NAN_INITS] > 0).all()


def test_plain_solve_gives_a_finite_pose_no_worse_than_the_reference():
    pc, lab, K, th0 = constructed_pair()
    P, cost = tf.solve_frustum_batch(pc, lab, K, theta0=th0, **SOLVE)
    assert torch.isfinite(P).all() and torch.isfinite(cost).all()
    _, c_ref = ref.solve(pc, lab, K, th0, **SOLVE)
    assert torch.isfinite(c_ref).all()
    assert float(cost[0]) <= float(c_ref[0])
    # the returned cost is the cost at the returned pose
    c_at = ref.cost_at(P, pc, lab, K, H=H, W=W, solver_stride=2)
    assert float(cost[0]) == pytest.approx(float(c_at[0]), abs=1e-5)


def test_non_finite_inits_rank_last_and_a_pair_without_a_finite_one():
    """A NaN theta of cost 0 and a NaN cost rank after every finite init;
    where every init is finite the key is the cost, bit for bit; a pair
    with no finite init gets the identity and cost 1e4."""
    nan = float("nan")
    thetas = torch.tensor([[[nan, 0, 0, 0], [0.1, 0, 0, 1], [0.2, 0, 0, 2],
                            [0.3, 0, 0, 3]],
                           [[nan, 0, 0, 0], [0.1, 0, 0, 1], [0.2, 0, 0, 2],
                            [0.3, 0, 0, 3]],
                           [[nan, 0, 0, 0], [0.1, nan, 0, 1], [0.2, 0, 0, 2],
                            [0.3, 0, 0, 3]]])
    costs = torch.tensor([[0.0, nan, 5.0, 4.0], [0.0, 3.0, 2.0, 1.0],
                          [0.0, 1.0, nan, math.inf]])
    key = tf._rank_key(thetas, costs)
    assert torch.equal(key[0], torch.tensor([math.inf, math.inf, 5.0, 4.0]))
    assert torch.equal(tf._select(thetas, costs, 2)[0], thetas[0, [3, 2]])
    pred = torch.ones(3, 8)
    P, cost = tf._pick(thetas, costs, pred, True)
    assert torch.equal(P[0], tf.theta_to_pose(thetas[0, 3]))
    assert cost[0] == 4.0
    assert torch.equal(P[1], tf.theta_to_pose(thetas[1, 3])) and cost[1] == 1
    assert torch.equal(P[2], torch.eye(4)) and cost[2] == 1e4
    fin = torch.tensor([[[0.1, 0, 0, 1], [0.2, 0, 0, 2]]])
    c = torch.tensor([[3.0, 2.0]])
    assert torch.equal(tf._rank_key(fin, c), c)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.chip
def test_kernel_probe_is_its_plain_version_on_the_card(card):
    """The probe launch on the card: finite, and bitwise the plain
    version run on the card (the kernel's twin under -fmad=false)."""
    pc, lab, K, th0 = constructed_pair()
    args = [x.to(card) for x in (*probe_inputs(pc, lab), K, th0)]
    th_k, c_k = lm_solve_cuda(*args, T_LB, T_UB, H=H, W=W, max_iter=8)
    th_p, c_p = lm_solve_plain(*args, T_LB, T_UB, H=H, W=W, max_iter=8)
    assert torch.isfinite(th_k).all() and torch.isfinite(c_k).all()
    assert torch.equal(th_k, th_p) and torch.equal(c_k, c_p)
    assert torch.equal(th_k[0, :NAN_INITS].cpu(), th0[0, :NAN_INITS])


@pytest.mark.chip
def test_kernel_solve_gives_a_finite_pose_on_the_card(card):
    pc, lab, K, th0 = constructed_pair()
    P, cost = tf.solve_frustum_batch(pc.to(card), lab.to(card), K.to(card),
                                     theta0=th0.to(card), **SOLVE)
    assert torch.isfinite(P).all() and torch.isfinite(cost).all()
    _, c_ref = ref.solve(pc, lab, K, th0, **SOLVE)
    assert float(cost[0]) <= float(c_ref[0])
