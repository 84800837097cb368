"""The port's LM solve (plain version, the CUDA kernel's oracle) against
the JAX package's ``lm_solve_pallas`` in interpret mode, same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register.frustum_pallas import lm_solve_pallas
from deepi2p_tpu_torch.register.frustum_cuda import (_cluster_sum,
                                                     _point_order, lm_layout,
                                                     lm_plan, lm_solve,
                                                     lm_solve_cuda,
                                                     lm_solve_plain)

H, W = 160, 512
K_NP = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]],
                np.float32)
T_LB = (-5.0, -0.1, -10.0)
T_UB = (5.0, 0.1, 10.0)


def problem(rng, B, N, I):
    """Ring clouds seen from a random yaw/translation, labels from the
    true projection, inits scattered around the truth (tz never 0)."""
    pts, labs, th0 = [], [], []
    for _ in range(B):
        yaw = rng.uniform(-np.pi, np.pi)
        t = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-3, 3)])
        ang = rng.uniform(0, 2 * np.pi, N)
        r = rng.uniform(5, 40, N)
        pc = np.stack([r * np.cos(ang), rng.uniform(-2, 2, N),
                       r * np.sin(ang)], -1).astype(np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        cam = pc @ R.T + t
        z = cam[:, 2]
        px = K_NP[0, 0] * cam[:, 0] / z + K_NP[0, 2]
        py = K_NP[1, 1] * cam[:, 1] / z + K_NP[1, 2]
        lab = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
               & (z > 0.1)).astype(np.float32)
        # 5% label noise, as a classifier would give
        flip = rng.random(N) < 0.05
        lab[flip] = 1.0 - lab[flip]
        th = np.stack([yaw + rng.normal(0, 0.3, I),
                       rng.normal(0, 1.0, I), np.zeros(I),
                       t[2] + rng.uniform(0.5, 3.0, I)
                       * rng.choice([-1, 1], I)], -1)
        pts.append(pc)
        labs.append(lab)
        th0.append(th.astype(np.float32))
    valid = (rng.random((B, N)) < 0.95).astype(np.float32)
    return (np.stack(pts), np.stack(labs), valid,
            np.tile(K_NP, (B, 1, 1)), np.stack(th0))


def run_both(arrays, max_iter, plan=None):
    th_t, c_t = lm_solve_plain(*(torch.from_numpy(a) for a in arrays),
                               T_LB, T_UB, H=H, W=W, max_iter=max_iter,
                               _plan=plan)
    th_j, c_j = lm_solve_pallas(*(jnp.asarray(a) for a in arrays), T_LB,
                                T_UB, H=H, W=W, max_iter=max_iter,
                                interpret=True)
    return th_t.numpy(), c_t.numpy(), np.asarray(th_j), np.asarray(c_j)


# max_iter=1: one sweep at theta0, one solve, one sweep at the proposal —
# only the order of the sums over points differs (f32), so 1e-5 relative.
# max_iter=8: the same, compounded over 8 accept/reject steps whose
# damping adapts to the iterates, so 1e-4 relative.
@pytest.mark.parametrize("N", [1024, 2048])
@pytest.mark.parametrize("I", [8, 16])
@pytest.mark.parametrize("max_iter,rtol", [(1, 1e-5), (8, 1e-4)])
def test_lm_plain_matches_pallas(N, I, max_iter, rtol):
    rng = np.random.default_rng(N + I + max_iter)
    arrays = problem(rng, B=2, N=N, I=I)
    th_t, c_t, th_j, c_j = run_both(arrays, max_iter)
    np.testing.assert_allclose(c_t, c_j, rtol=rtol, atol=0)
    np.testing.assert_allclose(th_t, th_j, rtol=rtol, atol=10 * rtol)


def test_lm_max_iter_zero_is_clipped_init():
    rng = np.random.default_rng(5)
    pts, lab, val, K, th0 = problem(rng, B=1, N=1024, I=8)
    th0[0, 0, 1] = 9.0                  # outside the tx bound
    th_t, c_t, th_j, c_j = run_both((pts, lab, val, K, th0), 0)
    assert th_t[0, 0, 1] == 5.0
    np.testing.assert_allclose(th_t, th_j, rtol=0, atol=0)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)


def test_lm_p6_is_not_ported():
    """The 6-DoF mode (P=6) is ported now (its parity tests are in
    test_torch_port_lm6.py): on the CPU it runs the plain version and
    keeps the shapes; any other P is refused."""
    rng = np.random.default_rng(0)
    pts, lab, val, K, _ = problem(rng, B=1, N=1024, I=8)
    th6 = torch.zeros(1, 8, 6)
    th6[..., 5] = 2.0
    args = [torch.from_numpy(a) for a in (pts, lab, val, K)]
    theta, cost = lm_solve(*args, th6, T_LB, T_UB, H=H, W=W, max_iter=1)
    assert tuple(theta.shape) == (1, 8, 6) and tuple(cost.shape) == (1, 8)
    assert bool(torch.isfinite(cost).all())
    with pytest.raises(ValueError, match="P=6"):
        lm_solve(*args, torch.zeros(1, 8, 5), T_LB, T_UB, H=H, W=W,
                 max_iter=1)


def test_lm_cuda_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in problem(rng, B=1, N=1024, I=8)]
    with pytest.raises(ValueError, match="CUDA"):
        lm_solve_cuda(*args, T_LB, T_UB, H=H, W=W, max_iter=1)


def test_lm_p4_plan_at_the_main_path_shapes():
    """The probe (B=32, N=5120, I=64) and the refine (N=10240, I=8) of the
    main path's halving solve: clusters of 2 blocks, 8 inits of 1 warp or
    4 inits of 4 warps per block, about 16 warps per SM of an H100, every
    block's points in shared memory; a pair too long for that gets larger
    clusters."""
    assert lm_plan(32, 5120, 64, 4) == (2, 8, 1)
    assert lm_plan(32, 10240, 8, 4) == (2, 4, 4)
    assert lm_plan(1, 100, 3, 4) == (2, 1, 16)
    assert lm_plan(2, 40960, 8, 4) == (8, 1, 16)
    for B, N, I in ((32, 5120, 64), (32, 10240, 8), (2, 40960, 8)):
        C, G, W = lm_plan(B, N, I, 4)
        assert lm_layout(N, C, W)[1] and G * W <= 16


def test_lm_p4_plan_at_the_eval_shapes():
    """The evaluation path's frustum solve at the KITTI shape (B=8, 60
    inits padded to 64, every point): probe N=5120, I=64; refine N=20480,
    I=8 in clusters of 4, each block's points in shared memory.  A pair
    of 81920 points is too long for shared memory even in clusters of 8,
    so its warps read the points from device memory."""
    assert lm_plan(8, 5120, 64, 4) == (2, 8, 2)
    assert lm_layout(5120, 2, 2) == (1280, True)
    assert lm_plan(8, 20480, 8, 4) == (4, 1, 16)
    assert lm_layout(20480, 4, 16) == (320, True)
    assert lm_plan(1, 81920, 8, 4) == (8, 1, 16)
    assert lm_layout(81920, 8, 16) == (640, False)


def _kernel_order_sum(x, V):
    """The P = 4 kernel's sum of x (N,) f32, written out: V virtual slices
    of S points, lane l of a slice adding its points l, l + 32, ... from 0,
    the xor butterfly of lane 0, then the slices in order."""
    N = x.shape[0]
    S = -(-N // (32 * V)) * 32
    parts = []
    for r in range(V):
        lanes = [np.float32(0.0)] * 32
        for p in range(r * S, min((r + 1) * S, N)):
            lane = (p - r * S) % 32
            lanes[lane] = np.float32(lanes[lane] + x[p])
        off = 16
        while off >= 1:
            lanes = [np.float32(lanes[l] + lanes[l ^ off]) for l in range(32)]
            off //= 2
        parts.append(lanes[0])
    tot = parts[0]
    for v in parts[1:]:
        tot = np.float32(tot + v)
    return tot


@pytest.mark.parametrize("N,V", [(20, 2), (100, 8), (1111, 2), (1111, 8),
                                 (4096, 1), (700, 16)])
def test_cluster_sum_is_the_kernels_order(N, V):
    """Bitwise the kernel's order, including empty slices (N=100 over 8
    slices of 32 points) and a slice shorter than a warp."""
    rng = np.random.default_rng(N + V)
    x = (rng.normal(size=(3, N)) * 10.0 ** rng.integers(-3, 4, (3, N))
         ).astype(np.float32)
    S, _ = lm_layout(N, V, 1)
    got = _cluster_sum(torch.from_numpy(x), V, S).numpy()
    want = np.array([_kernel_order_sum(row, V) for row in x], np.float32)
    np.testing.assert_array_equal(got, want)


def test_p4_point_order_puts_each_slices_inside_points_first():
    """The order in which a resident launch keeps the points: per slice of
    S points, the inside-labelled ones (label > 0.5; NaN is outside)
    first, each group in index order."""
    lab = torch.tensor([[0.0, 1.0, 0.9, 0.2, 1.0, float("nan"), 0.0, 1.0]])
    order = _point_order(lab, 4)
    assert order.tolist() == [[1, 2, 0, 3, 4, 7, 5, 6]]
    S, resident = lm_layout(10240, 2, 4)
    assert (S, resident) == (1280, True)
    assert lm_layout(6000, 1, 1) == (6016, False)


# the plain version summing in the cluster layout, against the Pallas
# kernel: N below C W x 32, so that slices are short or empty (40 points
# over 2 slices: 32 and 8; 200 over 8 slices of 32 points: the seventh has
# 8 points, the eighth none), N not a multiple of C W x 32 (1000, 1111),
# the probe-like plans (2 blocks of 8 inits, two groups; 1 block) and the
# refine-like ones (8 blocks; 2 blocks of 4 inits x 4 warps; the KITTI
# refine's 4 blocks of 1 init x 16 warps), and a pair
# too long for shared memory (6000 points in one block: read in index
# order, not partitioned by label); tolerances as in
# test_lm_plain_matches_pallas.  (At 20 and 100 points these rings are so
# ill-conditioned that the earlier 256-thread order parts from the Pallas
# kernel exactly as this one does, 7.7e-5 in the cost after one step;
# test_cluster_sum_is_the_kernels_order covers those sums.)
@pytest.mark.parametrize("N,I,plan", [(200, 8, (8, 8, 1)),
                                      (1000, 16, (2, 8, 1)),
                                      (1111, 8, (8, 8, 1)),
                                      (1111, 8, (2, 4, 4)),
                                      (1111, 8, (4, 1, 16)),
                                      (2048, 16, (1, 8, 1)),
                                      (6000, 8, (1, 8, 1))])
@pytest.mark.parametrize("max_iter,rtol", [(1, 1e-5), (8, 1e-4)])
def test_lm_cluster_order_matches_pallas(N, I, plan, max_iter, rtol):
    rng = np.random.default_rng(7 * N + I + max_iter)
    arrays = problem(rng, B=2, N=N, I=I)
    th_t, c_t, th_j, c_j = run_both(arrays, max_iter, plan=plan)
    np.testing.assert_allclose(c_t, c_j, rtol=rtol, atol=0)
    np.testing.assert_allclose(th_t, th_j, rtol=rtol, atol=10 * rtol)
