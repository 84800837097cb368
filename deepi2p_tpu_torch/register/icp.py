"""Point-to-point ICP against a (monodepth) pseudo point cloud, counterpart
of the JAX package's ``register/icp.py`` (reference Open3D harness,
``evaluation/icp/registration_icp.py``):

* pseudo point cloud from a depth map, ``K^-1 [u, v, 1] * depth``
  (``evaluation/icp/save_depth_map.py:60-102``);
* depth-scale calibration against the mean depth of GT-visible points
  (``registration_icp.py:216-219``);
* 60 random (tx, tz, ry) inits, best fitness wins, 2-D flattening of the
  result (``registration_icp.py:115-139``);
* fitness = inlier fraction at threshold 1.0 m, like Open3D's
  ``registration_icp`` (``registration_icp.py:148-162``).

:func:`icp_batch` runs all pairs x inits as ONE batch (the JAX package
walks init groups with ``lax.map``; the math is the same): each iteration
is one :func:`~deepi2p_tpu_torch.ops.nn1` call over the (pairs x inits)
query sets -- on the card one launch of the 1-NN kernel, which reads each
pair's pseudo cloud for all of that pair's inits -- then a batched
weighted Kabsch.  :func:`_icp_solve` sends CUDA tensors to
:func:`_icp_solve_cuda` (``icp_cuda``: a transform launch and an update
launch an iteration, the update summing each set's inlier moments and
solving its 3x3 Kabsch in float64; no host sync) and CPU tensors to
:func:`_icp_solve_plain`, whose Kabsch is
``torch.linalg.svd``; there the 3x3 products and the Kabsch covariance
are written as elementwise sums, so they stay f32 whatever the TF32
settings (the JAX package pins HIGHEST precision).  Inits come from a
``torch.Generator``, not ``jax.random``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.knn import nn1
from ..utils.profiling import span
from . import icp_cuda


class ICPResult(NamedTuple):
    P: torch.Tensor
    fitness: torch.Tensor


def depth_to_pointcloud(depth: torch.Tensor, K: torch.Tensor,
                        stride: int = 4) -> torch.Tensor:
    """Depth map (H, W) + intrinsics -> (M, 3) camera-frame points."""
    H, W = depth.shape
    d = depth[::stride, ::stride]
    kw = dict(dtype=torch.float32, device=depth.device)
    ys, xs = torch.meshgrid(torch.arange(0, H, stride, **kw),
                            torch.arange(0, W, stride, **kw), indexing="ij")
    K = K.to(depth.dtype)
    x = (xs - K[0, 2]) / K[0, 0] * d
    y = (ys - K[1, 2]) / K[1, 1] * d
    return torch.stack([x, y, d], dim=-1).reshape(-1, 3)


def calibrate_depth_scale(pc_cam_z, inside_mask, pseudo_z):
    """Scale factor aligning pseudo-cloud depth to the GT-visible mean
    (``registration_icp.py:216-219``)."""
    m = inside_mask.to(torch.float32)
    mean_gt = torch.sum(pc_cam_z * m) / torch.clamp(torch.sum(m), min=1.0)
    return mean_gt / torch.clamp(torch.mean(pseudo_z), min=1e-6)


def _mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as an elementwise sum (never TF32)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _mv3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as an elementwise sum."""
    return (A * v[..., None, :]).sum(dim=-1)


def _transform(src: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """src (..., N, 3) -> R src + t, for R (..., 3, 3), t (..., 3)."""
    x, y, z = src[..., 0], src[..., 1], src[..., 2]
    cols = [x * R[..., k, 0:1] + y * R[..., k, 1:2] + z * R[..., k, 2:3]
            + t[..., k:k + 1] for k in range(3)]
    return torch.stack(cols, dim=-1)


def _kabsch(src, dst, w):
    """Weighted point-to-point alignment: R, t minimising
    |R src + t - dst|, batched over the leading axes.

    src/dst (..., N, 3), w (..., N) -> (R (..., 3, 3), t (..., 3))."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)[..., None]
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    a = (src - mu_s[..., None, :]) * w[..., None]
    b = dst - mu_d[..., None, :]
    S = torch.sum(a[..., :, None] * b[..., None, :], dim=-3)   # a^T b
    U, _, Vh = torch.linalg.svd(S)
    V, Ut = Vh.mT, U.mT
    det = torch.linalg.det(_mm3(V, Ut))
    D = torch.ones_like(S[..., 0])
    D = torch.cat([D[..., :2], det[..., None]], dim=-1)
    R = _mm3(V * D[..., None, :], Ut)
    t = mu_d - _mv3(R, mu_s)
    return R, t


def _thr_schedule(threshold: float, coarse_threshold, max_iter: int):
    """Per-iteration correspondence thresholds (f32): the reference's fixed
    threshold, or a geometric anneal from ``coarse_threshold`` down to
    ``threshold`` (the Open3D multi-scale recipe in one loop)."""
    if coarse_threshold is None:
        return torch.full((max_iter,), threshold, dtype=torch.float32)
    return torch.from_numpy(np.geomspace(coarse_threshold, threshold,
                                         max_iter).astype(np.float32))


def _icp_solve(source, target, P_inits, thr_sched, threshold: float):
    """ICP from every init of every pair at once.

    source (B, N, 3), target (B, M, 3), P_inits (B, I, 4, 4) ->
    (P (B, I, 4, 4), fitness (B, I)).  One :func:`nn1` call per iteration
    over the B*I query sets, then one batched Kabsch: on the card
    :func:`_icp_solve_cuda`, elsewhere :func:`_icp_solve_plain`."""
    if source.device.type == "cuda":
        return _icp_solve_cuda(source, target, P_inits, thr_sched,
                               threshold)
    return _icp_solve_plain(source, target, P_inits, thr_sched, threshold)


def _pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Poses (..., 4, 4) float32 from R (..., 3, 3) and t (..., 3)."""
    P = torch.zeros(*R.shape[:-2], 4, 4, dtype=torch.float32,
                    device=R.device)
    P[..., :3, :3] = R
    P[..., :3, 3] = t
    P[..., 3, 3] = 1.0
    return P


def _icp_solve_plain(source, target, P_inits, thr_sched, threshold: float):
    """:func:`_icp_solve` in PyTorch ops, on any device (the CPU's path)."""
    B, I = P_inits.shape[:2]
    N = source.shape[1]
    src = source[:, None]                                  # (B, 1, N, 3)
    tgt = target[:, None].expand(-1, I, -1, -1)            # (B, I, M, 3)
    R, t = P_inits[..., :3, :3], P_inits[..., :3, 3]

    def nearest(R, t):
        with span("icp.nn1"):
            moved = _transform(src, R, t)                  # (B, I, N, 3)
            d2m, nn = nn1(moved.reshape(B * I, N, 3), target)
            return d2m.reshape(B, I, N), nn.reshape(B, I, N)

    for thr in thr_sched.tolist():
        d2m, nn = nearest(R, t)
        with span("icp.update"):
            w = (torch.sqrt(d2m) < thr).to(torch.float32)
            dst = torch.gather(tgt, 2,
                               nn.long()[..., None].expand(-1, -1, -1, 3))
            Rn, tn = _kabsch(src, dst, w)
            ok = torch.sum(w, dim=-1) >= 3
            R = torch.where(ok[..., None, None], Rn, R)
            t = torch.where(ok[..., None], tn, t)
    with span("icp.fitness"):
        d2m, _ = nearest(R, t)
        fitness = torch.mean((d2m < threshold ** 2).to(torch.float32), dim=-1)
        P = _pose(R, t)
    return P, fitness


def _icp_solve_cuda(source, target, P_inits, thr_sched, threshold: float):
    """:func:`_icp_solve` on the card, with no host sync: per iteration
    ``icp_cuda.transform`` into one reused buffer, the 1-NN, and
    ``icp_cuda.update`` (inlier moments and a float64 Kabsch per set,
    poses updated in place), 2 launches of ``icp_cuda`` besides the
    1-NN's; the fitness pass's transform is one more."""
    B, I = P_inits.shape[:2]
    N = source.shape[1]
    src, tgt = source.contiguous(), target.contiguous()
    rt = icp_cuda.pose_rows(P_inits[..., :3, :3], P_inits[..., :3, 3])
    tgt4 = icp_cuda.pad_rows(tgt)
    moved = torch.empty(B * I, N, 3, dtype=torch.float32,
                        device=source.device)

    def nearest():
        with span("icp.nn1"):
            return nn1(icp_cuda.transform(src, rt, moved), tgt)

    for thr in thr_sched.tolist():
        d2, nn = nearest()
        with span("icp.update"):
            icp_cuda.update(src, tgt4, d2, nn, rt, thr)
    with span("icp.fitness"):
        d2, _ = nearest()
        fitness = torch.mean((d2 < threshold ** 2).to(torch.float32),
                             dim=-1).reshape(B, I)
        P = _pose(rt[:, :9].reshape(B, I, 3, 3), rt[:, 9:].reshape(B, I, 3))
    return P, fitness


def icp_point_to_point(source, target, P_init, *, threshold: float = 1.0,
                       max_iter: int = 30, coarse_threshold=None
                       ) -> ICPResult:
    """Fixed-iteration point-to-point ICP aligning source (N, 3) onto
    target (M, 3) from P_init (4, 4), on the tensors' device.

    ``coarse_threshold``: optional start of a multi-scale anneal down to
    ``threshold`` (see :func:`_thr_schedule`)."""
    thr = _thr_schedule(threshold, coarse_threshold, max_iter)
    P, fit = _icp_solve(source.float()[None], target.float()[None],
                        P_init.float()[None, None], thr, threshold)
    return ICPResult(P=P[0, 0], fitness=fit[0, 0])


def flatten_2d(P: torch.Tensor) -> torch.Tensor:
    """Force the y-axis unknowns out of the solution
    (``registration_icp.py:127-133``): the rotation block becomes the
    Frobenius-nearest rotation about y (polar decomposition of the xz
    2x2, in closed form), as the JAX package does.  P (..., 4, 4)."""
    ry = torch.atan2(P[..., 0, 2] - P[..., 2, 0], P[..., 0, 0] + P[..., 2, 2])
    out = P.clone()
    out[..., :3, :3] = _rot_y(ry)
    return out


def _rot_y(ry: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(ry), torch.sin(ry)
    z, o = torch.zeros_like(ry), torch.ones_like(ry)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _make_P_ry(ry: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Poses (..., 4, 4) from a yaw (...) and a translation (..., 3)."""
    P = torch.zeros(*ry.shape, 4, 4, dtype=ry.dtype, device=ry.device)
    P[..., :3, :3] = _rot_y(ry)
    P[..., :3, 3] = t
    P[..., 3, 3] = 1.0
    return P


def _draw_inits(generator: torch.Generator, shape, t_amplitude,
                ry_amplitude: float) -> torch.Tensor:
    """Blind inits (*shape, 4, 4): ``ry ~ U(-a, a) * 2``,
    ``t ~ U(-1, 1) * t_amplitude`` (``registration_icp.py:115-139``), drawn
    on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
    ry = (torch.rand(*shape, **kw) * 2.0 - 1.0) * ry_amplitude * 2.0
    t = (torch.rand(*shape, 3, **kw) * 2.0 - 1.0) * torch.tensor(
        [float(v) for v in t_amplitude], device=generator.device)
    return _make_P_ry(ry, t)


def _seeded_inits(generator: torch.Generator, n_inits: int, P_seed, *,
                  ry_jitter: float = 0.35, t_jitter=(2.0, 0.0, 2.0)):
    """Inits clustered around seed poses P_seed (B, 4, 4): init 0 is the
    exact seed, the rest are yaw/translation perturbations of it -- the
    basin-widening seeding the reference lacks.  -> (B, n_inits, 4, 4)."""
    B = P_seed.shape[0]
    kw = dict(generator=generator, device=generator.device)
    ry = (torch.rand(B, n_inits, **kw) * 2.0 - 1.0) * ry_jitter
    dt = (torch.rand(B, n_inits, 3, **kw) * 2.0 - 1.0) * torch.tensor(
        [float(v) for v in t_jitter], device=generator.device)
    ry[:, 0] = 0.0
    dt[:, 0] = 0.0
    jit_P = _make_P_ry(ry, dt)
    seed = P_seed.to(jit_P.device, torch.float32)[:, None]
    out = torch.empty_like(jit_P)
    out[..., :3, :3] = _mm3(jit_P[..., :3, :3], seed[..., :3, :3])
    out[..., :3, 3] = _mv3(jit_P[..., :3, :3], seed[..., :3, 3]) \
        + jit_P[..., :3, 3]
    out[..., 3, :] = seed[..., 3, :]
    return out


def _pick_best(P, fit):
    """Best-fitness init per pair, flattened to 2-D; identity when even
    the best one has fitness <= 0.001.  P (B, I, 4, 4), fit (B, I)."""
    best = torch.argmax(fit, dim=1)
    P_best = flatten_2d(P[torch.arange(P.shape[0], device=P.device), best])
    fit_best = fit.gather(1, best[:, None])[:, 0]
    eye = torch.eye(4, dtype=P.dtype, device=P.device).expand_as(P_best)
    P_best = torch.where((fit_best > 0.001)[:, None, None], P_best, eye)
    return ICPResult(P=P_best, fitness=fit_best)


def icp_random_init(source, target, generator: torch.Generator, *,
                    n_inits: int = 60, threshold: float = 1.0,
                    max_iter: int = 30, t_amplitude=(5.0, 0.0, 10.0),
                    ry_amplitude: float = math.pi) -> ICPResult:
    """Random (tx, tz, ry) inits for one pair, best fitness, 2-D
    flattened (``registration_icp.py:115-139``); on the tensors' device."""
    dev = source.device
    P_inits = _draw_inits(generator, (1, n_inits), t_amplitude,
                          ry_amplitude).to(dev)
    P, fit = _icp_solve(source.float()[None], target.float()[None], P_inits,
                        _thr_schedule(threshold, None, max_iter), threshold)
    res = _pick_best(P, fit)
    return ICPResult(P=res.P[0], fitness=res.fitness[0])


def icp_batch(source, target, generator: torch.Generator, *,
              n_inits: int = 60, threshold: float = 1.0, max_iter: int = 30,
              t_amplitude=(5.0, 0.0, 10.0), ry_amplitude: float = math.pi,
              init_chunk: int = 8, coarse_threshold=None,
              P_seed=None, seed_frac: float = 0.5,
              device="cuda") -> ICPResult:
    """Batched multi-init ICP: every pair x init in one batch on ``device``.

    Args:
      source: (B, N, 3); target: (B, M, 3) pseudo clouds, padded to a
        common M with a far sentinel (e.g. 1e6) -- sentinel points are
        never nearest neighbours and never inliers.  Tensors or arrays.
      generator: draws the inits, on its own device (so one CPU generator
        gives the same inits on the card and on the CPU).
      n_inits: rounded up to a multiple of ``init_chunk``, as the JAX
        package's init groups are.
      coarse_threshold: optional multi-scale anneal start.
      P_seed: optional (B, 4, 4) seed poses: ``seed_frac`` of the inits
        cluster around the pair's seed, the rest are blind draws.
      device: where the solve runs (the card unless the caller names the
        CPU).
    Returns:
      ICPResult(P (B, 4, 4), fitness (B,)).
    """
    with span("icp.batch"):                # its id: a call count
        dev = resolve_device(device)
        source = torch.as_tensor(source).to(dev, torch.float32)
        target = torch.as_tensor(target).to(dev, torch.float32)
        B = source.shape[0]
        n_round = -(-n_inits // init_chunk) * init_chunk
        with span("icp.inits"):
            P_inits = _draw_inits(generator, (B, n_round), t_amplitude,
                                  ry_amplitude)
            if P_seed is not None:
                n_seed = int(n_round * seed_frac)
                seeded = _seeded_inits(generator, n_seed,
                                       torch.as_tensor(P_seed))
                P_inits = torch.cat([seeded, P_inits[:, n_seed:]], dim=1)
            P_inits = P_inits.to(dev)
        P, fit = _icp_solve(
            source, target, P_inits,
            _thr_schedule(threshold, coarse_threshold, max_iter), threshold)
        with span("icp.pick"):
            return _pick_best(P, fit)
