"""ICP's iteration on the card (``register/icp_cuda.py``, ``csrc/icp.cu``).

The update's plain version is ``icp._kabsch`` on the same inliers.  On
the CPU: ``_kabsch`` in float64, the card tests' reference, against its
float32 run on random inlier sets, reflections and planar sets; the
constants the wrapper shares with the source; ``pad_rows`` and
``pose_rows``; that a CPU tensor takes the plain path; the wrappers'
refusals, and that only the tensors read as float4 must be 16-byte
aligned.

On the card (marker ``chip``; ``python -m pytest --noconftest -m chip
tests/test_torch_port_icp_cuda.py``): the update's moments and float64
R, t against ``_kabsch`` in float64 on those sets, too few inliers, the
rank-deficient fallbacks and exact rotations; the transform bitwise
``icp._transform``; one iteration's inlier count and 1-NN bitwise the
plain path's; a source given as an offset view; a whole ``icp_batch``
bitwise repeatable; the iterations and the fitness pass with no host
sync; the launches a batch.
"""
import math

import numpy as np
import pytest
import torch

from deepi2p_tpu_torch import _build
from deepi2p_tpu_torch.ops.knn import nn1
from deepi2p_tpu_torch.ops.knn_cuda import nn1_cuda
from deepi2p_tpu_torch.register import icp as ti
from deepi2p_tpu_torch.register import icp_cuda as ic
from torch_port_fixtures import one_torch_thread  # noqa: F401

R_TOL, T_TOL = 1e-5, 1e-4       # against _kabsch's float32 SVD
F64_TOL = 1e-9                  # float64 against float64


def rotation(rng, angle=None) -> np.ndarray:
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    a = rng.uniform(-math.pi, math.pi) if angle is None else angle
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    return np.eye(3) + math.sin(a) * K + (1 - math.cos(a)) * K @ K


def inlier_set(case: str, seed: int, N: int = 400):
    """(src, dst, w) float32 / bool: an anisotropic cloud off the origin,
    moved rigidly with noise; ``reflection`` mirrors dst in z (the best
    orthogonal map has det -1), ``planar`` puts src in z = 0, ``few``
    keeps 2 inliers."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(N, 3)) * [6.0, 2.5, 0.8] + rng.normal(size=3) * 20
    if case == "planar":
        src[:, 2] = 0.0
    dst = src @ rotation(rng).T + rng.normal(size=3) * 5
    dst += rng.normal(size=(N, 3)) * 0.05
    if case == "reflection":
        dst[:, 2] *= -1.0
    w = rng.random(N) < 0.7
    if case == "few":
        w[:] = False
        w[[3, 17]] = True
    f = torch.float32
    return (torch.tensor(src, dtype=f), torch.tensor(dst, dtype=f),
            torch.tensor(w))


CASES = [("random", s) for s in range(6)] + [
    ("reflection", 10), ("reflection", 11), ("planar", 20), ("planar", 21)]


def moments64(src, dst, w):
    """(..., 16) float64: W, sum src, sum dst, sum src dst^T (row-major)
    over the inliers w (..., N); src, dst (..., N, 3) broadcast."""
    sel = w.bool()[..., None]
    s = torch.where(sel, src.double(), 0.0)
    d = torch.where(sel, dst.double(), 0.0)
    C = (s[..., :, None] * d[..., None, :]).sum(dim=-3)
    W = sel.sum(dim=(-2, -1)).double()
    return torch.cat([W[..., None], s.sum(dim=-2), d.sum(dim=-2),
                      C.flatten(-2)], dim=-1)


def is_rotation(R, tol=1e-12) -> bool:
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return bool((R @ R.mT - eye).abs().max() < tol) \
        and abs(float(torch.linalg.det(R)) - 1.0) < tol


@pytest.mark.parametrize("case,seed", CASES)
def test_kabsch_in_float64_is_the_reference(case, seed):
    """The card tests hold the kernel's float64 R, t to ``_kabsch`` run in
    float64: that is within 1e-5 / 1e-4 of ``_kabsch``'s float32 run, a
    proper rotation, and on a reflection the sign correction is in use."""
    src, dst, w = inlier_set(case, seed)
    R64, t64 = ti._kabsch(src.double(), dst.double(), w.double())
    Rk, tk = ti._kabsch(src, dst, w.float())
    assert (R64 - Rk.double()).abs().max() < R_TOL
    assert (t64 - tk.double()).abs().max() < T_TOL
    assert is_rotation(R64)
    if case == "reflection":
        m = moments64(src, dst, w)
        S = m[7:].reshape(3, 3) - (m[1:4] / m[0])[:, None] * m[None, 4:7]
        U, _, Vh = torch.linalg.svd(S)
        assert float(torch.linalg.det(Vh.mT @ U.mT)) < 0


def test_constants_match_the_source():
    assert ic.STATS == ic.SUMS + 12 and ic.SUMS == 16
    assert ic.MIN_INLIERS == 3
    assert {"icp_transform_f32", "icp_update_f32"} <= set(_build.SIGNATURES)


def test_pad_rows():
    tgt = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    t4 = ic.pad_rows(tgt)
    assert t4.shape == (2, 4, 4) and t4.is_contiguous()
    assert torch.equal(t4[..., :3], tgt) and not t4[..., 3].any()


def test_pose_rows_keep_the_pose_layout():
    rng = np.random.default_rng(60)
    P = torch.tensor(rng.normal(size=(2, 3, 4, 4)), dtype=torch.float32)
    rt = ic.pose_rows(P[..., :3, :3], P[..., :3, 3])
    assert rt.shape == (6, 12) and rt.is_contiguous()
    back = ti._pose(rt[:, :9].reshape(2, 3, 3, 3), rt[:, 9:].reshape(2, 3, 3))
    assert torch.equal(back[..., :3, :], P[..., :3, :])
    assert torch.equal(back[..., 3, :], torch.tensor([0.0, 0, 0, 1]).expand(
        2, 3, 4))


def icp_problem(B=2, N=1500, M=1200, seed=70):
    """B pairs: a source cloud, and its first M points moved by a small
    yaw and shift (with a little noise) as the target."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-12, 12, (B, N, 3)).astype(np.float32)
    src[..., 1] *= 0.2
    tgt = np.empty((B, M, 3), np.float32)
    for b in range(B):
        ry = rng.uniform(-0.2, 0.2)
        c, s = math.cos(ry), math.sin(ry)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        tgt[b] = src[b, :M] @ R.T + [rng.uniform(-1, 1), 0,
                                      rng.uniform(-1, 1)]
    tgt += rng.normal(size=tgt.shape).astype(np.float32) * 0.01
    return torch.from_numpy(src), torch.from_numpy(tgt)


def test_a_cpu_tensor_takes_the_plain_path():
    src, tgt = icp_problem(N=96, M=80)
    before = ic.launches
    res = ti.icp_batch(src, tgt, torch.Generator().manual_seed(1),
                       n_inits=8, max_iter=4, device="cpu")
    gen = torch.Generator().manual_seed(1)
    P_inits = ti._draw_inits(gen, (2, 8), (5.0, 0.0, 10.0), math.pi)
    P, fit = ti._icp_solve_plain(src, tgt, P_inits,
                                 ti._thr_schedule(1.0, None, 4), 1.0)
    want = ti._pick_best(P, fit)
    assert ic.launches == before
    assert torch.equal(res.P, want.P) and torch.equal(res.fitness,
                                                      want.fitness)


def _bad_transform_args():
    src = torch.zeros(2, 64, 3)
    rt = torch.zeros(8, 12)
    out = torch.zeros(8, 64, 3)
    return {
        "src rank": ((src[0], rt, out), ValueError),
        "sets not a multiple of pairs": ((src, rt[:7], out[:7]), ValueError),
        "rt width": ((src, torch.zeros(8, 9), out), ValueError),
        "out shape": ((src, rt, out[:, :63]), ValueError),
        "src strided": ((torch.zeros(2, 3, 64).transpose(1, 2), rt, out),
                        ValueError),
        "src float64": ((src.double(), rt, out), TypeError),
        "rt float16": ((src, rt.half(), out), TypeError),
        "on the CPU": ((src, rt, out), ValueError),
    }


def _bad_update_args():
    src, tgt = torch.zeros(2, 64, 3), torch.zeros(2, 40, 4)
    d2, idx = torch.zeros(8, 64), torch.zeros(8, 64, dtype=torch.int32)
    rt = torch.zeros(8, 12)
    stats = torch.zeros(8, ic.STATS, dtype=torch.float64)
    return {
        "tgt pairs": ((src, tgt[:1], d2, idx, rt, 1.0), ValueError),
        "tgt unpadded": ((src, tgt[..., :3], d2, idx, rt, 1.0), ValueError),
        "d2 shape": ((src, tgt, d2[:, :63], idx, rt, 1.0), ValueError),
        "idx shape": ((src, tgt, d2, idx[:4], rt, 1.0), ValueError),
        "stats width": ((src, tgt, d2, idx, rt, 1.0, stats[:, :16]),
                        ValueError),
        "idx int64": ((src, tgt, d2, idx.long(), rt, 1.0), TypeError),
        "d2 float64": ((src, tgt, d2.double(), idx, rt, 1.0), TypeError),
        "stats float32": ((src, tgt, d2, idx, rt, 1.0, stats.float()),
                          TypeError),
        "on the CPU": ((src, tgt, d2, idx, rt, 1.0, stats), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_transform_args()))
def test_transform_refuses(case):
    args, err = _bad_transform_args()[case]
    before = ic.launches
    with pytest.raises(err):
        ic.transform(*args)
    assert ic.launches == before


@pytest.mark.parametrize("case", list(_bad_update_args()))
def test_update_refuses(case):
    args, err = _bad_update_args()[case]
    before = ic.launches
    with pytest.raises(err):
        ic.update(*args)
    assert ic.launches == before


def offset(shape, dtype=torch.float32) -> torch.Tensor:
    """A contiguous view of ``shape`` one element into its storage, so
    its address is not a multiple of 16 bytes."""
    n = math.prod(shape)
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _offset_args():
    src, tgt = torch.zeros(2, 64, 3), torch.zeros(2, 40, 4)
    d2, idx = torch.zeros(8, 64), torch.zeros(8, 64, dtype=torch.int32)
    rt, out = torch.zeros(8, 12), torch.zeros(8, 64, 3)
    return {
        "transform src": (ic.transform, (offset((2, 64, 3)), rt, out), False),
        "transform out": (ic.transform, (src, rt, offset((8, 64, 3))), False),
        "transform rt": (ic.transform, (src, offset((8, 12)), out), True),
        "update src": (ic.update, (offset((2, 64, 3)), tgt, d2, idx, rt,
                                   1.0), False),
        "update d2 idx": (ic.update, (src, tgt, offset((8, 64)), offset(
            (8, 64), torch.int32), rt, 1.0), False),
        "update tgt4": (ic.update, (src, offset((2, 40, 4)), d2, idx, rt,
                                    1.0), True),
        "update rt": (ic.update, (src, tgt, d2, idx, offset((8, 12)), 1.0),
                      True),
    }


@pytest.mark.parametrize("case", list(_offset_args()))
def test_only_float4_inputs_must_be_aligned(case):
    """``rt`` and ``tgt4`` are read as float4 and must be 16-byte aligned;
    every other tensor may be a view at any offset, so on the CPU its
    refusal is for the device, not for its address."""
    fn, args, aligned = _offset_args()[case]
    assert any(a.data_ptr() % 16 for a in args if torch.is_tensor(a))
    before = ic.launches
    with pytest.raises(ValueError, match="16-byte aligned" if aligned
                       else "one CUDA device"):
        fn(*args)
    assert ic.launches == before


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def card_inputs(B=2, I=16, N=1500, M=1200, seed=70):
    src, tgt = icp_problem(B, N, M, seed)
    gen = torch.Generator().manual_seed(seed)
    P0 = ti._draw_inits(gen, (B, I), (2.0, 0.0, 2.0), 0.3)
    return src.cuda(), tgt.cuda(), P0.cuda()


def kernel_update(src, dst, w, R0, t0):
    """One update launch on one set whose i-th point pairs with dst[i]:
    the pair's target is dst, idx the identity, d2 0 for an inlier and 4
    (out of the threshold 1) for the rest.  -> (stats (STATS,) float64,
    rt (12,) float32), on the CPU."""
    N = src.shape[0]
    stats = torch.full((1, ic.STATS), float("nan"), dtype=torch.float64,
                       device="cuda")
    rt = ic.pose_rows(R0[None], t0[None]).cuda()
    d2 = torch.where(w, 0.0, 4.0).float()[None].cuda()
    idx = torch.arange(N, dtype=torch.int32, device="cuda")[None]
    ic.update(src.float().contiguous()[None].cuda(),
              ic.pad_rows(dst.contiguous()[None].cuda()), d2,
              idx, rt, 1.0, stats)
    return stats[0].cpu(), rt[0].cpu()


@pytest.mark.chip
@pytest.mark.parametrize("case,seed", CASES)
def test_the_update_is_kabsch_in_float64(card, case, seed):
    src, dst, w = inlier_set(case, seed)
    stats, rt = kernel_update(src, dst, w, torch.eye(3), torch.zeros(3))
    m = moments64(src, dst, w)
    assert float(stats[0]) == float(w.sum())
    scale = m.abs().clamp(min=1.0)
    assert ((stats[:ic.SUMS] - m).abs() / scale).max() < 1e-12
    R, t = stats[ic.SUMS:ic.SUMS + 9].reshape(3, 3), stats[ic.SUMS + 9:]
    R64, t64 = ti._kabsch(src.double(), dst.double(), w.double())
    assert (R - R64).abs().max() < F64_TOL
    assert (t - t64).abs().max() < F64_TOL
    Rk, tk = ti._kabsch(src, dst, w.float())
    assert (R - Rk.double()).abs().max() < R_TOL
    assert (t - tk.double()).abs().max() < T_TOL
    assert is_rotation(R)
    assert torch.equal(rt, stats[ic.SUMS:].float())


@pytest.mark.chip
def test_too_few_inliers_keep_the_pose(card):
    src, dst, w = inlier_set("few", 30)
    rng = np.random.default_rng(31)
    R0 = torch.tensor(rotation(rng), dtype=torch.float32)
    t0 = torch.tensor([1.5, -2.0, 0.25])
    stats, rt = kernel_update(src, dst, w, R0, t0)
    assert float(stats[0]) == 2.0 < ic.MIN_INLIERS
    assert torch.equal(rt, ic.pose_rows(R0[None], t0[None])[0])


@pytest.mark.chip
def test_the_update_fallbacks_stay_rotations(card):
    """S = 0 (every inlier on one point) gives the identity, as
    ``_kabsch``'s SVD of a zero matrix does; a rank-1 S (collinear
    points) a proper rotation that maps the line onto its image."""
    p, q = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([4.0, 5.0, 6.0])
    on = torch.ones(12, dtype=torch.bool)
    stats, _ = kernel_update(p.expand(12, 3), q.expand(12, 3), on,
                             torch.eye(3), torch.zeros(3))
    R, t = stats[ic.SUMS:ic.SUMS + 9].reshape(3, 3), stats[ic.SUMS + 9:]
    assert torch.equal(R, torch.eye(3, dtype=torch.float64))
    assert torch.equal(t, (q - p).double())
    # a quarter turn about z and a shift: exact in float32
    line = torch.arange(12.0)[:, None] * torch.tensor([1.0, 2.0, -0.5])
    dst = torch.stack([-line[:, 1], line[:, 0], line[:, 2]], -1) + 3.0
    stats, _ = kernel_update(line, dst, on, torch.eye(3), torch.zeros(3))
    R, t = stats[ic.SUMS:ic.SUMS + 9].reshape(3, 3), stats[ic.SUMS + 9:]
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    assert is_rotation(R)
    assert torch.allclose(line.double() @ R.T + t, dst.double(), atol=1e-9)


@pytest.mark.chip
@pytest.mark.parametrize("rows", [
    [[0, 0, 1], [1, 0, 0], [0, 1, 0]], [[-1, 0, 0], [0, -1, 0], [0, 0, 1]]],
    ids=["third-turn", "half-turn"])
def test_the_update_recovers_an_exact_rotation(card, rows):
    """Points on a 1/32 grid, moved by a rotation with entries 0 and +-1
    and a shift, all exact in float32: R and t come back to float64
    rounding."""
    rng = np.random.default_rng(41)
    src = torch.tensor(rng.integers(-400, 400, (200, 3)) / 32.0
                       * [4, 2, 1], dtype=torch.float32)
    Rt = torch.tensor(rows, dtype=torch.float32)
    tt = torch.tensor([0.5, -4.0, 7.0])
    stats, _ = kernel_update(src, src @ Rt.T + tt,
                             torch.ones(200, dtype=torch.bool), torch.eye(3),
                             torch.zeros(3))
    R, t = stats[ic.SUMS:ic.SUMS + 9].reshape(3, 3), stats[ic.SUMS + 9:]
    assert (R - Rt.double()).abs().max() < 1e-13
    assert (t - tt.double()).abs().max() < 1e-12


@pytest.mark.chip
def test_an_offset_source_view(card):
    """A pair's cloud as a view into a larger tensor, its address off 16
    bytes, runs and gives the poses of its own copy."""
    src, tgt, P0 = card_inputs(N=1499, M=1200)
    view = src[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    thr = ti._thr_schedule(1.0, None, 6)
    P, fit = ti._icp_solve(view, tgt[1:], P0[1:], thr, 1.0)
    Pc, fitc = ti._icp_solve(view.clone(), tgt[1:], P0[1:], thr, 1.0)
    assert torch.equal(P, Pc) and torch.equal(fit, fitc)


@pytest.mark.chip
@pytest.mark.parametrize("shape", [(2, 16, 1500), (3, 5, 257), (1, 1, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_transform_is_bitwise_transform(card, shape):
    B, I, N = shape
    src, _, P0 = card_inputs(B, I, N, M=min(N, 100))
    src = src * 37.0 + 0.1        # coordinates of ray-cast scale
    rt = ic.pose_rows(P0[..., :3, :3], P0[..., :3, 3])
    out = torch.full((B * I, N, 3), float("nan"), device=card)
    before = ic.launches
    ic.transform(src, rt, out)
    want = ti._transform(src[:, None], P0[..., :3, :3], P0[..., :3, 3])
    assert ic.launches - before == 1
    assert torch.equal(out, want.reshape(B * I, N, 3))


@pytest.mark.chip
def test_one_iteration_against_the_plain_path(card):
    src, tgt, P0 = card_inputs()
    P0[0, 1, :3, 3] += 1e3          # a set with no inliers keeps its pose
    B, I = P0.shape[:2]
    N = src.shape[1]
    thr = 1.5
    R0, t0 = P0[..., :3, :3], P0[..., :3, 3]
    rt = ic.pose_rows(R0, t0)
    moved = torch.empty(B * I, N, 3, device=card)
    d2, idx = nn1(ic.transform(src, rt, moved), tgt)
    d2p, idxp = nn1(ti._transform(src[:, None], R0, t0).reshape(B * I, N, 3),
                    tgt)
    assert torch.equal(d2, d2p) and torch.equal(idx, idxp)
    stats = torch.full((B * I, ic.STATS), float("nan"), dtype=torch.float64,
                       device=card)
    ic.update(src, ic.pad_rows(tgt), d2, idx, rt, thr, stats)
    torch.cuda.synchronize()
    w = (torch.sqrt(d2p) < thr).reshape(B, I, N)
    dst = torch.gather(tgt[:, None].expand(-1, I, -1, -1), 2,
                       idxp.long().reshape(B, I, N, 1).expand(-1, -1, -1, 3))
    m = moments64(src[:, None], dst, w).reshape(B * I, ic.SUMS)
    assert torch.equal(stats[:, 0], w.sum(-1).double().reshape(-1))
    scale = m.abs().amax(0, keepdim=True).clamp(min=1.0)
    assert ((stats[:, :ic.SUMS] - m).abs() / scale).max() < 1e-12
    R, t = ti._kabsch(src[:, None].double(), dst.double(), w.double())
    R, t = R.reshape(B * I, 9), t.reshape(B * I, 3)
    ok = m[:, 0] >= ic.MIN_INLIERS
    assert not ok[1] and int(ok.sum()) == B * I - 1
    assert (stats[ok, ic.SUMS:ic.SUMS + 9] - R[ok]).abs().max() < F64_TOL
    assert (stats[ok, ic.SUMS + 9:] - t[ok]).abs().max() < F64_TOL
    got = rt.double()
    assert (got[ok, :9] - R[ok]).abs().max() < 1e-6
    assert (got[ok, 9:] - t[ok]).abs().max() < 1e-5
    kept = ic.pose_rows(R0, t0)[~ok]
    assert torch.equal(rt[~ok], kept)


@pytest.mark.chip
def test_icp_batch_repeats_bitwise(card):
    src, tgt, _ = card_inputs(N=3000, M=2000)
    runs = [ti.icp_batch(src, tgt, torch.Generator().manual_seed(3),
                         n_inits=16, max_iter=12) for _ in range(2)]
    assert torch.equal(runs[0].P, runs[1].P)
    assert torch.equal(runs[0].fitness, runs[1].fitness)


@pytest.mark.chip
def test_icp_solve_never_syncs(card):
    src, tgt, P0 = card_inputs()
    thr = ti._thr_schedule(1.0, 4.0, 6)
    ti._icp_solve(src, tgt, P0, thr, 1.0)     # builds, plans, allocates
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        P, fit = ti._icp_solve(src, tgt, P0, thr, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert P.shape == (2, 16, 4, 4) and torch.isfinite(P).all()
    assert fit.shape == (2, 16) and float(fit.max()) > 0.75


@pytest.mark.chip
def test_launches_a_batch(card):
    src, tgt, _ = card_inputs()
    iters = 9
    before = (ic.launches, nn1_cuda.launches)
    ti.icp_batch(src, tgt, torch.Generator().manual_seed(4), n_inits=16,
                 max_iter=iters)
    assert ic.launches - before[0] == 2 * iters + 1
    assert nn1_cuda.launches - before[1] == iters + 1


@pytest.mark.chip
def test_the_card_agrees_with_the_plain_path(card):
    """Well-posed pairs: nearly every init ends where the plain path (on
    the card) ends, and each pair's best fitness is the plain path's; an
    init may part where a point lies at the threshold within the f32
    SVD's rounding and flips."""
    src, tgt, P0 = card_inputs()
    thr = ti._thr_schedule(1.0, None, 20)
    P, fit = ti._icp_solve_cuda(src, tgt, P0, thr, 1.0)
    Pp, fitp = ti._icp_solve_plain(src, tgt, P0, thr, 1.0)
    gap = (P - Pp).abs().amax(dim=(-2, -1)).flatten()
    assert float((gap < 1e-3).double().mean()) >= 0.9, gap
    best, best_p = fit.amax(1), fitp.amax(1)
    assert (best - best_p).abs().max() <= 0.01
