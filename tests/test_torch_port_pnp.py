"""The port's RANSAC PnP (``register/pnp.py``) against the JAX package's:
each helper against its JAX twin at 1e-5 relative (norm-wise), pose
recovery and the guards on the JAX tests' own problems
(``test_register_extra.py:54-104``), with the minimal sets of JAX's Gumbel
draws and with the port's own draw, the port's draw of the minimal sets,
and the batch form.  The whole solve fed JAX's draws is held to JAX's
poses in ``test_torch_port_pnp_harness.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register import pnp as jpnp
from deepi2p_tpu.register.frustum import rodrigues as jax_rodrigues
from deepi2p_tpu_torch.register import pnp
from deepi2p_tpu_torch.register.frustum import rodrigues
from deepi2p_tpu_torch.register.metrics import pose_diff_np

from test_register_extra import K_np, W_FINE, _pnp_problem

RTOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def jax_subsets(g, coarse, size=8):
    """The minimal sets (..., Hyp, size) that the JAX package takes from
    its Gumbel noise g (..., Hyp, N): the top ``size`` of ``log(max(mask,
    1e-20)) + g`` (its ``approx_max_k`` is exact on the CPU)."""
    mask = torch.as_tensor(np.asarray(coarse)).to(torch.float32)
    scores = (torch.log(torch.clamp(mask, min=1e-20))[..., None, :]
              + torch.as_tensor(np.asarray(g)))
    return torch.topk(scores, size, dim=-1).indices


def _close(got, want, scale=None):
    """Norm-wise relative: max |got - want| <= 1e-5 * scale, the scale
    max |want| unless given (entries near 0 of a rotation sit at the f32
    rounding of the large ones)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want)) if scale is None else scale
    assert err <= RTOL * scale, (err, got, want)


@pytest.fixture(scope="module")
def problem():
    pc, coarse, fine, P_gt = _pnp_problem(np.random.default_rng(0))
    return pc, coarse, fine, P_gt


def _dlt_inputs(problem, n_sets=4, size=64):
    """Sets of 64 inside points, their projections at cell resolution
    jittered by 0.01 cell, and the cell-resolution intrinsics: a
    well-conditioned DLT, so that 1e-5 tests the arithmetic.  Minimal sets
    on cell centres are not: the 12x12 normal matrix's two smallest
    eigenvalues lie within ~3x of each other, and f32 rounding alone moves
    a set's t by ~1e-4 relative in either package (the solver on cell
    centres is held to JAX's in ``test_solve_pnp_on_jax_noise_matches_jax``).
    Nor are exact projections: their smallest eigenvalue rounds to <= 0 in
    f32, the pivot floor (1e-20) then overflows the inverse iteration, and
    both packages return a zero DLT."""
    pc, coarse, _, P_gt = problem
    inside = np.flatnonzero(coarse)
    idx = np.random.default_rng(1).choice(inside, (n_sets, size),
                                          replace=False)
    K_fine = K_np / 32.0
    K_fine[2, 2] = 1.0
    cam = pc @ P_gt[:3, :3].T + P_gt[:3, 3]
    uv = (cam[:, :2] / cam[:, 2:]) * np.diag(K_fine)[:2] + K_fine[:2, 2]
    uv = uv + np.random.default_rng(2).normal(0.0, 0.01, uv.shape)
    return (pc[idx], uv[idx].astype(np.float32), K_fine,
            np.linalg.inv(K_fine).astype(np.float32))


def test_fine_label_to_cell_matches_jax():
    lab = np.asarray([0, 1, W_FINE, W_FINE + 2, 79])
    for center in (False, True):
        np.testing.assert_array_equal(
            pnp.fine_label_to_cell(_t(lab), W_FINE, center=center).numpy(),
            np.asarray(jpnp.fine_label_to_cell(jnp.asarray(lab), W_FINE,
                                               center=center)))


def test_dlt_helpers_match_jax(problem):
    """_smallest_eigvec (on the DLT normal matrices), _orthogonalize,
    _dlt_pose and _reproj_err, per minimal set."""
    X, uv, K_fine, K_inv = _dlt_inputs(problem)
    pc, _, fine, _ = problem
    R_t, t_t = pnp._dlt_pose(_t(X), _t(uv), _t(K_inv))
    uv_all = np.asarray(jpnp.fine_label_to_cell(jnp.asarray(fine), W_FINE,
                                                center=True))
    err_t = pnp._reproj_err(R_t, t_t, _t(pc)[None], _t(uv_all)[None],
                            _t(K_fine))
    rng = np.random.default_rng(2)
    # jitted once: eager calls retrace the helpers' scans every time
    jax_dlt, jax_orth = jax.jit(jpnp._dlt_pose), jax.jit(jpnp._orthogonalize)
    for i in range(X.shape[0]):
        R_j, t_j = jax_dlt(jnp.asarray(X[i]), jnp.asarray(uv[i]),
                           jnp.asarray(K_inv))
        _close(R_t[i], R_j)
        # t comes out of M [X; 1] through the points' lever arm (~20 m
        # here): its rounding scales with the cloud's distance, not |t|
        _close(t_t[i], t_j, scale=np.linalg.norm(X[i], axis=-1).mean())
        err_j = jpnp._reproj_err(R_j, t_j, jnp.asarray(pc),
                                 jnp.asarray(uv_all), jnp.asarray(K_fine))
        _close(err_t[i], err_j)
        # a DLT normal matrix (12x12, PSD, near-null direction)
        A = rng.normal(size=(16, 12)).astype(np.float32)
        A[:, -1] = A[:, :11] @ rng.normal(size=11).astype(np.float32) * 1e-3
        AtA = (A.T @ A).astype(np.float32)
        _close(pnp._smallest_eigvec(_t(AtA)),
               jax.jit(jpnp._smallest_eigvec)(jnp.asarray(AtA)))
        M = rng.normal(size=(3, 3)).astype(np.float32)
        _close(pnp._orthogonalize(_t(M)), jax_orth(jnp.asarray(M)))
    # behind the camera: 1e6, as the JAX twin
    R = np.eye(3, dtype=np.float32)
    t = np.asarray([0.0, 0.0, -100.0], np.float32)
    _close(pnp._reproj_err(_t(R), _t(t), _t(pc), _t(uv_all), _t(K_fine)),
           jpnp._reproj_err(jnp.asarray(R), jnp.asarray(t), jnp.asarray(pc),
                            jnp.asarray(uv_all), jnp.asarray(K_fine)))


def test_rotation_helpers_and_gn_refine_match_jax(problem):
    """Rodrigues with its hand-derived Jacobian (the near-zero branch
    included) against ``jacfwd``, the rotation-to-angle-axis inverse, and
    the Gauss-Newton polish."""
    rng = np.random.default_rng(3)
    aa = (rng.normal(size=(6, 3)) * 0.8).astype(np.float32)
    aa[0] = 0.0
    aa[1] = [1e-9, 0.0, 0.0]
    R = rodrigues(_t(aa))
    got = pnp._rotmat_to_aa(R)
    R2, dR = pnp._rodrigues_jac(_t(aa))
    jac = jax.jit(jax.jacfwd(jax_rodrigues))
    for i in range(len(aa)):
        R_j = jax_rodrigues(jnp.asarray(aa[i]))
        _close(R[i], R_j)
        _close(R2[i], R_j)
        # dR[j] = dR / d aa_j; jacfwd puts the input axis last
        _close(dR[i], np.moveaxis(np.asarray(jac(jnp.asarray(aa[i]))), -1, 0))
        _close(got[i], jpnp._rotmat_to_aa(R_j))

    # GN polish from a perturbed true pose, weights = the inside mask
    pc, coarse, fine, P_gt = problem
    K_fine = K_np / 32.0
    K_fine[2, 2] = 1.0
    uv = np.asarray(jpnp.fine_label_to_cell(jnp.asarray(fine), W_FINE,
                                            center=True))
    R0 = (np.asarray(jax_rodrigues(jnp.asarray([0.02, -0.03, 0.01])))
          @ P_gt[:3, :3]).astype(np.float32)
    t0 = (P_gt[:3, 3] + [0.3, -0.1, 0.5]).astype(np.float32)
    w = coarse.astype(np.float32)
    R_t, t_t = pnp._gn_refine(*(_t(x)[None] for x in (R0, t0, pc, uv,
                                                       K_fine, w)))
    R_t, t_t = R_t[0], t_t[0]
    R_j, t_j = jax.jit(jpnp._gn_refine)(jnp.asarray(R0), jnp.asarray(t0),
                               jnp.asarray(pc), jnp.asarray(uv),
                               jnp.asarray(K_fine), jnp.asarray(w))
    _close(R_t, R_j)
    _close(t_t, t_j)


@pytest.mark.parametrize("n_inside", [512, 37, 5])
def test_draw_subsets_uniform_without_replacement(n_inside):
    """The port's draw of the minimal sets: 8 distinct points per
    hypothesis, all inside when 8 or more are; fewer, then every inside
    point and distinct outside ones.  Each candidate point is drawn as
    often as a uniform draw expects, in every slot (4000 hypotheses; 6
    standard deviations); the same seed gives the same sets."""
    N, H, S = 512, 4000, 8
    mask = torch.zeros(1, N)
    mask[0, torch.randperm(N, generator=torch.Generator().manual_seed(2))
         [:n_inside]] = 1.0
    sub = pnp.draw_subsets(torch.Generator().manual_seed(3), mask, H, S)[0]
    assert sub.shape == (H, S) and sub.dtype == torch.int64
    srt = torch.sort(sub, -1).values
    assert bool(torch.all(srt[:, 1:] != srt[:, :-1]))
    inside = mask[0, sub] > 0
    pool = mask[0] > 0 if n_inside >= S else mask[0] == 0
    k = S if n_inside >= S else S - n_inside
    assert bool(torch.all(inside.sum(-1) == min(n_inside, S)))
    picks = sub[inside if n_inside >= S else ~inside].reshape(H, k)
    n_pool = int(pool.sum())
    for col, q in ([(picks, k / n_pool)]
                   + [(picks[:, i], 1.0 / n_pool) for i in range(k)]):
        cnt = torch.bincount(col.reshape(-1), minlength=N)[pool].double()
        mean, sd = H * q, math.sqrt(H * q * (1.0 - q))
        assert float((cnt - mean).abs().max()) <= 6.0 * sd, (cnt, mean)
    again = pnp.draw_subsets(torch.Generator().manual_seed(3), mask, H, S)
    assert torch.equal(again[0], sub)


def test_solve_pnp_on_jax_noise_recovers_pose(problem):
    """``test_pnp_recovers_pose`` (key 0, 128 hypotheses) with JAX's own
    Gumbel draw of that key; the whole solve fed JAX's draws is held to
    JAX's poses in ``test_torch_port_pnp_harness.py``."""
    pc, coarse, fine, P_gt = problem
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0),
                                     (128, pc.shape[0])))
    res = pnp.solve_pnp(_t(pc), _t(coarse), _t(fine), _t(K_np),
                        W_fine=W_FINE, subset=jax_subsets(g, coarse))
    rte, rre = pose_diff_np(res.P.numpy().astype(np.float64),
                            P_gt.astype(np.float64))
    assert rte < 2.0 and rre < 5.0 and float(res.n_inliers) > 10
    assert 0.0 <= float(res.cost) < 1.0


def test_solve_pnp_recovers_pose_over_seeds(problem):
    """RANSAC over 128 cell-quantised hypotheses misses now and then: over
    12 draws the port's CPU generator (seed 0) succeeds as often as JAX's
    keys 0-11 do through the same solver (both at least 9 of 12; 12 and
    11 measured)."""
    pc, coarse, fine, P_gt = problem
    S, n = 12, pc.shape[0]
    rep = [_t(np.repeat(x[None], S, 0)) for x in (pc, coarse, fine, K_np)]
    g_jax = np.stack([np.asarray(jax.random.gumbel(jax.random.PRNGKey(s),
                                                   (128, n)))
                      for s in range(S)])
    for kw in (dict(generator=torch.Generator().manual_seed(0)),
               dict(subset=jax_subsets(g_jax, rep[1]))):
        res = pnp.solve_pnp_batch(*rep, W_fine=W_FINE, n_hypotheses=128,
                                  **kw)
        ok = sum(a < 2.0 and b < 5.0 for a, b in (
            pose_diff_np(res.P[i].double().numpy(), P_gt.astype(np.float64))
            for i in range(S)))
        assert ok >= 9, (sorted(kw), ok)


def test_pnp_quality_class_of_jax_solver():
    """``test_pnp_matches_cv2_quality``'s problem, with the JAX solver (key
    1, 256 hypotheses) as the oracle in place of OpenCV: the port's draw
    lands in the same quality class."""
    pc, coarse, fine, P_gt = _pnp_problem(np.random.default_rng(0),
                                          yaw=-0.8, t=(1.0, 0.2, 2.0))
    res = pnp.solve_pnp(_t(pc), _t(coarse), _t(fine), _t(K_np),
                        torch.Generator().manual_seed(1), W_fine=W_FINE,
                        n_hypotheses=256)
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (256, 512)))
    ref = pnp.solve_pnp(_t(pc), _t(coarse), _t(fine), _t(K_np),
                        W_fine=W_FINE, subset=jax_subsets(g, coarse))
    rte_j, rre_j = pose_diff_np(ref.P.double().numpy(),
                                P_gt.astype(np.float64))
    rte, rre = pose_diff_np(res.P.double().numpy(), P_gt.astype(np.float64))
    assert rte < max(2.0, 2.0 * rte_j + 0.5)
    assert rre < max(5.0, 2.0 * rre_j + 0.5)


def test_pnp_guards():
    """Fewer than 4 inside points: identity, cost 1 (the JAX test's
    problem); a translation beyond 14.14 m: identity, cost 1."""
    rng = np.random.default_rng(0)
    pc = rng.normal(size=(32, 3)).astype(np.float32)
    coarse = np.zeros(32, np.int64)
    coarse[:2] = 1
    res = pnp.solve_pnp(_t(pc), _t(coarse), torch.zeros(32, dtype=torch.int64),
                        _t(K_np), torch.Generator().manual_seed(0),
                        W_fine=W_FINE, n_hypotheses=16)
    np.testing.assert_array_equal(res.P.numpy(), np.eye(4))
    assert float(res.cost) == 1.0

    far = _pnp_problem(np.random.default_rng(1), t=(0.0, 0.0, 20.0))
    res = pnp.solve_pnp(*(_t(x) for x in far[:3]), _t(K_np),
                        torch.Generator().manual_seed(0), W_fine=W_FINE,
                        n_hypotheses=64)
    np.testing.assert_array_equal(res.P.numpy(), np.eye(4))
    assert float(res.cost) == 1.0


def test_pnp_batch_equals_per_pair_solves():
    """Three pairs in one batch give each pair's own solve on its slice of
    the minimal sets: poses within 1e-5 and the same inliers where the solve
    passes the guards, the identity fallback where it does not (there the
    batched and the single reductions' rounding may part a chaotic
    search), and the generator path draws those sets."""
    rng = np.random.default_rng(6)
    probs = [_pnp_problem(rng, yaw=rng.uniform(-1, 1),
                          t=(rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)))
             for _ in range(3)]
    stack = [_t(np.stack([p[i] for p in probs])) for i in range(3)]
    Ks = _t(np.tile(K_np, (3, 1, 1)))
    sub = pnp.draw_subsets(torch.Generator().manual_seed(4),
                           stack[1].to(torch.float32), 128, 8)
    res = pnp.solve_pnp_batch(*stack, Ks, W_fine=W_FINE, subset=sub)
    assert res.P.shape == (3, 4, 4) and res.cost.shape == (3,)
    for i, p in enumerate(probs):
        one = pnp.solve_pnp(*(_t(x) for x in p[:3]), _t(K_np),
                            W_fine=W_FINE, subset=sub[i])
        torch.testing.assert_close(res.P[i], one.P, rtol=0, atol=1e-5)
        assert (float(res.cost[i]) < 1.0) == (float(one.cost) < 1.0)
        if float(one.cost) < 1.0:
            assert float(res.n_inliers[i]) == float(one.n_inliers)
    assert (res.cost < 1.0).sum() >= 1
    res2 = pnp.solve_pnp_batch(*stack, Ks, torch.Generator().manual_seed(4),
                               W_fine=W_FINE, n_hypotheses=128)
    torch.testing.assert_close(res2.P, res.P, rtol=0, atol=0)
