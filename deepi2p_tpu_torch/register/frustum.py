"""Inverse-camera-projection registration, counterpart of the JAX
package's ``register/frustum.py`` (reference Ceres solver,
``evaluation/frustum_reg/src/registration.cpp:9-186``, run over random
inits by ``evaluation/registration_lsq.py:142-186``).

:func:`solve_frustum_batch` is the 2-D mode (``theta = [ry, tx, ty, tz]``)
with the successive-halving policy of the JAX package's Pallas branch
(``frustum.py:439-477``): probe every init for ``min(8, max_iter)``
iterations on a further point subsample, keep the best eighth (a multiple
of 8, at least 8) by cost, refine those for the remaining iterations, take
the argmin.  Both LM phases are one launch each of the LM kernel on the
card (:mod:`.frustum_cuda`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .frustum_cuda import lm_solve

I_BLK = 8          # init block of the JAX package's Pallas kernel


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), with the
    first-order form near zero."""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta2 + 1e-24)
    k = aa / theta[..., None]
    z = torch.zeros_like(theta)

    def skew(v):
        return torch.stack([
            torch.stack([z, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], z, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)

    K = skew(k)
    s, c = torch.sin(theta)[..., None, None], torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    R = eye + s * K + (1.0 - c) * (K @ K)
    R0 = eye + skew(aa)
    return torch.where((theta2 > 1e-16)[..., None, None], R, R0)


def theta_to_pose(theta: torch.Tensor) -> torch.Tensor:
    """2-D params (..., 4) = [ry, tx, ty, tz] -> poses (..., 4, 4).

    The rotation about y is built from cos(ry) and sin(ry), the terms the
    LM cost uses.  The JAX package goes through ``rodrigues``, which gives
    the same matrix to rounding but squares ry first (f32 overflow for
    |ry| > 1.8e19)."""
    ry = theta[..., 0]
    c, s = torch.cos(ry), torch.sin(ry)
    P = torch.zeros(*theta.shape[:-1], 4, 4, dtype=theta.dtype,
                    device=theta.device)
    P[..., 0, 0] = c
    P[..., 0, 2] = s
    P[..., 1, 1] = 1.0
    P[..., 2, 0] = -s
    P[..., 2, 2] = c
    P[..., :3, 3] = theta[..., 1:4]
    P[..., 3, 3] = 1.0
    return P


def initial_guess(pc: torch.Tensor, pred_inside: torch.Tensor):
    """Yaw init and front-crop validity mask per pair
    (``evaluation/registration_lsq.py:196-220``).

    pc (B, N, 3), pred_inside (B, N) {0,1} -> (ang (B,), valid (B, N))."""
    m = pred_inside.to(pc.dtype)
    cnt = torch.clamp(m.sum(dim=1), min=1.0)
    mean = (pc * m[..., None]).sum(dim=1) / cnt[:, None]
    ang = torch.atan2(mean[:, 2], mean[:, 0]) - math.pi / 2
    ang = torch.remainder(ang + math.pi, 2 * math.pi) - math.pi
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    rot_z = -s * pc[..., 0] + c * pc[..., 2]
    inf = torch.full_like(rot_z, math.inf)
    min_in_z = torch.amin(torch.where(m > 0.5, rot_z, inf), dim=1)
    valid = (rot_z > (min_in_z - 10.0)[:, None]).to(pc.dtype)
    return ang, valid


def sample_inits(generator: torch.Generator, ang: torch.Tensor, n_inits: int,
                 *, init_t_amplitude: float = 10.0,
                 ry_sigma: float = 10.0 * math.pi / 180.0) -> torch.Tensor:
    """Random 2-D inits ``[ry ~ N(ang, sigma), 0, 0, tz ~ U(-a, a)]`` per
    pair (``registration_lsq.py:160-168``): ang (B,) -> (B, n_inits, 4).
    The draws come from ``generator`` (on ``ang``'s device); they are not
    the JAX package's ``jax.random`` numbers."""
    B = ang.shape[0]
    kw = dict(generator=generator, device=ang.device, dtype=ang.dtype)
    ry = ang[:, None] + ry_sigma * torch.randn(B, n_inits, **kw)
    tz = (torch.rand(B, n_inits, **kw) * 2.0 - 1.0) * init_t_amplitude
    z = torch.zeros_like(ry)
    return torch.stack([ry, z, z, tz], dim=-1)


def solve_frustum_batch(pc, pred_inside, K, *, H: int, W: int,
                        generator: Optional[torch.Generator] = None,
                        n_inits: int = 60, max_iter: int = 32,
                        t_lb=(-5.0, -0.1, -10.0), t_ub=(5.0, 0.1, 10.0),
                        solver_stride: int = 1, theta0=None):
    """Multi-init frustum solve for a batch of pairs (2-D mode).

    Args:
      pc (B, N, 3) f32, pred_inside (B, N) {0,1}, K (B, 3, 3), all on one
      device; the LM phases run on the card for CUDA tensors.
      generator: draws the inits when ``theta0`` is not given.
      theta0: optional (B, I, 4) inits (replays, and parity with the JAX
        package, whose ``jax.random`` draws differ from torch's).
      solver_stride: subsample of the points fed to the LM; the probe
        takes every ``max(1, 4 // solver_stride)``-th of those (every 4th
        point in total).
    Returns:
      (P (B, 4, 4), cost (B,)); a pair with no inside points gets the
      identity pose and cost 1e4.
    """
    probe_stride = max(1, 4 // solver_stride)
    pc = pc.float()
    K = K.float().contiguous()
    ang, valid = initial_guess(pc, pred_inside)
    if theta0 is None:
        if generator is None:
            raise ValueError("need a generator when theta0 is not given")
        theta0 = sample_inits(generator, ang, n_inits)
    theta0 = theta0.float()
    # a multiple of I_BLK inits, padded by repeating the first (never a new
    # draw), as the JAX package's Pallas branch does
    pad = (-theta0.shape[1]) % I_BLK
    if pad:
        theta0 = torch.cat([theta0, theta0[:, :1].expand(-1, pad, -1)], 1)
    theta0 = theta0.contiguous()

    def sub(x, stride):
        return x[:, ::stride].contiguous()

    labels = pred_inside.to(pc.dtype)
    pc_s, lab_s, val_s = (sub(x, solver_stride) for x in (pc, labels, valid))
    kw = dict(H=H, W=W)
    I = theta0.shape[1]
    probe_iter = min(8, max_iter)
    if max_iter > probe_iter and I >= 4 * I_BLK:
        ps = probe_stride
        thetas, costs = lm_solve(sub(pc_s, ps), sub(lab_s, ps),
                                 sub(val_s, ps), K, theta0, t_lb, t_ub,
                                 max_iter=probe_iter, **kw)
        keep = max((I // 8) // I_BLK * I_BLK, I_BLK)        # best eighth
        top = torch.argsort(costs, dim=1, stable=True)[:, :keep]
        theta_top = torch.gather(thetas, 1, top[:, :, None].expand(-1, -1, 4))
        thetas, costs = lm_solve(pc_s, lab_s, val_s, K,
                                 theta_top.contiguous(), t_lb, t_ub,
                                 max_iter=max_iter - probe_iter, **kw)
    else:
        thetas, costs = lm_solve(pc_s, lab_s, val_s, K, theta0, t_lb, t_ub,
                                 max_iter=max_iter, **kw)

    best = torch.argmin(costs, dim=1, keepdim=True)             # (B, 1)
    best_theta = torch.gather(thetas, 1, best[:, :, None].expand(-1, -1, 4))
    best_theta = best_theta[:, 0]
    best_cost = torch.gather(costs, 1, best)[:, 0]
    P = theta_to_pose(best_theta)
    has_inside = pred_inside.sum(dim=1) > 0
    eye = torch.eye(4, dtype=P.dtype, device=P.device).expand_as(P)
    P = torch.where(has_inside[:, None, None], P, eye)
    best_cost = torch.where(has_inside, best_cost,
                            torch.full_like(best_cost, 1e4))
    return P, best_cost
