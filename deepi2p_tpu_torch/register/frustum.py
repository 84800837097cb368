"""Inverse-camera-projection registration, counterpart of the JAX
package's ``register/frustum.py`` (reference Ceres solver,
``evaluation/frustum_reg/src/registration.cpp:9-186``, run over random
inits by ``evaluation/registration_lsq.py:142-186``).

:func:`solve_frustum_batch` solves the 2-D mode (``theta = [ry, tx, ty,
tz]``) or the 6-DoF mode (``theta = [rx, ry, rz, tx, ty, tz]``,
``registration_3d.hpp``) with the successive-halving policy of the JAX
package's Pallas branch (``frustum.py:439-477``): probe every init for
``min(8, max_iter)`` iterations on a further point subsample, keep the best
eighth (a multiple of 8, at least 8) by cost, refine those for the
remaining iterations, take the argmin.  Both LM phases are one launch each
of the LM kernel on the card (:mod:`.frustum_cuda`).

A weighted or margin-relaxed cost (``outside_weight != 1``,
``point_weights``, ``edge_margin_px != 0``) goes to :func:`lm_solve_generic`
instead, the counterpart of the JAX package's autodiff ``lm_solve``
(``frustum.py:216-283``, its ``backend="generic"``): every init for the
full budget, Jacobian by forward-mode autodiff, no kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .frustum_cuda import _chol_solve, _clip_t, lm_solve

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


def theta_to_pose(theta: torch.Tensor, is_2d: bool = True) -> torch.Tensor:
    """Params -> poses (..., 4, 4) (``registration.cpp:161-180``).

    2-D params (..., 4) = [ry, tx, ty, tz]: the rotation about y is built
    from cos(ry) and sin(ry), the terms the LM cost uses.  The JAX package
    goes through ``rodrigues``, which gives the same matrix to rounding but
    squares ry first (f32 overflow for |ry| > 1.8e19).  6-DoF params
    (..., 6) = [rx, ry, rz, tx, ty, tz]: ``rodrigues`` of the angle-axis."""
    if not is_2d:
        P = torch.zeros(*theta.shape[:-1], 4, 4, dtype=theta.dtype,
                        device=theta.device)
        P[..., :3, :3] = rodrigues(theta[..., :3])
        P[..., :3, 3] = theta[..., 3:6]
        P[..., 3, 3] = 1.0
        return P
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
                 ry_sigma: float = 10.0 * math.pi / 180.0,
                 is_2d: bool = True) -> torch.Tensor:
    """Random inits per pair (``registration_lsq.py:160-168``),
    ``ry ~ N(ang, sigma)``, ``tz ~ U(-a, a)``: ang (B,) -> (B, n_inits, 4)
    as ``[ry, 0, 0, tz]``, or (B, n_inits, 6) as ``[0, ry, 0, 0, 0, tz]``
    for the 6-DoF mode.  The draws come from ``generator`` (on ``ang``'s
    device); they are not the JAX package's ``jax.random`` numbers."""
    B = ang.shape[0]
    kw = dict(generator=generator, device=ang.device, dtype=ang.dtype)
    ry = ang[:, None] + ry_sigma * torch.randn(B, n_inits, **kw)
    tz = (torch.rand(B, n_inits, **kw) * 2.0 - 1.0) * init_t_amplitude
    z = torch.zeros_like(ry)
    if is_2d:
        return torch.stack([ry, z, z, tz], dim=-1)
    return torch.stack([z, ry, z, z, z, tz], dim=-1)


def _residuals_t(theta, pts, labels, valid, K, H: int, W: int, is_2d: bool,
                 edge_margin_px: float = 0.0):
    """Blockwise residuals (B, I, 3, N) of the reference cost, the JAX
    package's ``_residuals_t`` for a batch: theta (B, I, P), pts (B, N, 3),
    labels/valid (B, N), K (B, 3, 3).  ``edge_margin_px`` relaxes both
    label tests by that many pixels (0 is the exact reference cost,
    ``registration.cpp:95-118``)."""
    if is_2d:
        z = torch.zeros_like(theta[..., 0])
        aa = torch.stack([z, theta[..., 0], z], dim=-1)
        t = theta[..., 1:4]
    else:
        aa, t = theta[..., :3], theta[..., 3:6]
    R = rodrigues(aa)                                   # (B, I, 3, 3)
    x, y, zz = (pts[:, None, :, d] for d in range(3))  # (B, 1, N)
    p = [R[..., k, 0:1] * x + R[..., k, 1:2] * y + R[..., k, 2:3] * zz
         + t[..., k:k + 1] for k in range(3)]
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    zc = p[2]
    px = fx * p[0] / zc + cx
    py = fy * p[1] / zc + cy
    H1, W1 = H - 1.0, W - 1.0
    m = edge_margin_px
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    r_in0 = torch.maximum(-m - px, zero) + torch.maximum(px - W1 - m, zero)
    r_in1 = torch.maximum(-m - py, zero) + torch.maximum(py - H1 - m, zero)
    r_in2 = torch.maximum(-zc, zero) * 100.0
    xd = W1 * 0.5 - torch.abs(px - W1 * 0.5) - m
    yd = H1 * 0.5 - torch.abs(py - H1 * 0.5) - m
    # a select (0, not inf * 0 = NaN, at zc == 0), as the JAX package's
    # compiled ``(xd + yd) * gate`` is
    r_out0 = torch.where((zc > 0) & (xd > 0) & (yd > 0), xd + yd, zero)
    is_in = labels[:, None] > 0.5
    r0 = torch.where(is_in, r_in0, r_out0)
    r1 = torch.where(is_in, r_in1, zero)
    r2 = torch.where(is_in, r_in2, zero)
    return torch.stack([r0, r1, r2], dim=-2) * valid[:, None, None, :]


def _block_cost(r, valid, pw=None):
    """0.5 * sum pw * log(1 + |r_block|^2) over valid blocks; r is
    (B, I, 3, N), valid/pw (B, N) -> (B, I)."""
    s = torch.sum(r * r, dim=-2)
    w = valid if pw is None else valid * pw
    return 0.5 * torch.sum(torch.log1p(s) * w[:, None], dim=-1)


def _outside_pw(labels, outside_weight: float):
    """Per-point block weight: 1 inside-labelled, ``outside_weight``
    outside-labelled; None when the weight is exactly 1."""
    if outside_weight == 1.0:
        return None
    return torch.where(labels > 0.5, 1.0, float(outside_weight)).to(
        labels.dtype)


def frustum_cost(theta, pts, labels, valid, K, H: int, W: int,
                 is_2d: bool = True, outside_weight: float = 1.0,
                 edge_margin_px: float = 0.0):
    """Robustified total cost (B, I) of theta (B, I, P) for points
    (B, N, 3)."""
    r = _residuals_t(theta, pts, labels, valid, K, H, W, is_2d,
                     edge_margin_px)
    return _block_cost(r, valid, _outside_pw(labels, outside_weight))


class LMResult(NamedTuple):
    theta: torch.Tensor
    cost: torch.Tensor
    n_accepted: torch.Tensor


def lm_solve_generic(pts, labels, valid, K, theta0, t_lb, t_ub, *, H: int,
                     W: int, max_iter: int = 32, is_2d: bool = True,
                     outside_weight: float = 1.0, point_weights=None,
                     edge_margin_px: float = 0.0) -> LMResult:
    """LM with an autodiff Jacobian for a batch of pairs x inits: the JAX
    package's ``frustum.lm_solve`` (its ``vmap`` over pairs and inits
    written out as the leading (B, I) axes).

    Args:
      pts (B, N, 3), labels/valid (B, N), K (B, 3, 3), theta0 (B, I, P)
      with P = 4 (2-D) or 6 (6-DoF); t_lb/t_ub 3 translation bounds each.
      point_weights: optional (B, N) per-point block weights in the
        robust cost; outside_weight / edge_margin_px as in
        :func:`_outside_pw` / :func:`_residuals_t`.
    Returns:
      LMResult(theta (B, I, P), cost (B, I), n_accepted (B, I)).
    """
    pts, labels, valid = pts.float(), labels.float(), valid.float()
    K = K.float()
    P = theta0.shape[-1]
    pw = _outside_pw(labels, outside_weight)
    if point_weights is not None:
        pw = point_weights if pw is None else pw * point_weights
    vw = valid if pw is None else valid * pw
    eye = torch.eye(P, dtype=pts.dtype, device=pts.device)

    def res_fn(theta):
        return _residuals_t(theta, pts, labels, valid, K, H, W, is_2d,
                            edge_margin_px)

    def jacobian(theta):
        cols = []
        for j in range(P):
            r, dr = torch.func.jvp(res_fn, (theta,),
                                   (eye[j].expand_as(theta),))
            cols.append(dr)
        return r, torch.stack(cols, dim=-1)         # (B, I, 3, N, P)

    theta = _clip_t(theta0.float(), t_lb, t_ub)
    lam = torch.full(theta.shape[:2], 1e-3, dtype=theta.dtype,
                     device=theta.device)
    cost = _block_cost(res_fn(theta), valid, pw)
    n_acc = torch.zeros(theta.shape[:2], dtype=torch.int32,
                        device=theta.device)
    upper = [(i, j) for i in range(P) for j in range(i, P)]
    for _ in range(max_iter):
        r, J = jacobian(theta)
        s = torch.sum(r * r, dim=-2)                 # (B, I, N)
        w = vw[:, None] / (1.0 + s)
        Jw = J * w[..., None, :, None]
        Hmat = torch.einsum("birnp,birnq->bipq", Jw, J)
        g = torch.einsum("birnp,birn->bip", Jw, r)
        Hm = torch.stack([Hmat[..., i, j] for i, j in upper], dim=-1)
        theta_new = _clip_t(theta - _chol_solve(Hm, g, lam), t_lb, t_ub)
        new_cost = _block_cost(res_fn(theta_new), valid, pw)
        accept = new_cost < cost
        theta = torch.where(accept[..., None], theta_new, theta)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 3.0),
                          min=1e-9, max=1e9)
        n_acc = n_acc + accept.to(torch.int32)
    return LMResult(theta=theta, cost=cost, n_accepted=n_acc)


def solve_frustum_batch(pc, pred_inside, K, *, H: int, W: int,
                        generator: Optional[torch.Generator] = None,
                        n_inits: int = 60, max_iter: int = 32,
                        t_lb=(-5.0, -0.1, -10.0), t_ub=(5.0, 0.1, 10.0),
                        is_2d: bool = True, solver_stride: int = 1,
                        theta0=None, outside_weight: float = 1.0,
                        point_weights=None, edge_margin_px: float = 0.0):
    """Multi-init frustum solve for a batch of pairs.

    Args:
      pc (B, N, 3) f32, pred_inside (B, N) {0,1}, K (B, 3, 3), all on one
      device; the LM phases run on the card for CUDA tensors.
      generator: draws the inits when ``theta0`` is not given.
      is_2d: the 2-D mode (``[ry, t]``) or the 6-DoF mode (``[aa, t]``).
      theta0: optional (B, I, P) inits (replays, and parity with the JAX
        package, whose ``jax.random`` draws differ from torch's).
      solver_stride: subsample of the points fed to the LM; the probe
        takes every ``max(1, 4 // solver_stride)``-th of those (every 4th
        point in total).
      outside_weight / point_weights (B, N) / edge_margin_px: a weighted or
        margin-relaxed cost; any of them routes the solve to
        :func:`lm_solve_generic` (full budget for every init, no halving).
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
        theta0 = sample_inits(generator, ang, n_inits, is_2d=is_2d)
    theta0 = theta0.float()
    P_dim = theta0.shape[2]

    def sub(x, stride):
        return x[:, ::stride].contiguous()

    labels = pred_inside.to(pc.dtype)
    pc_s, lab_s, val_s = (sub(x, solver_stride) for x in (pc, labels, valid))
    generic = (outside_weight != 1.0 or point_weights is not None
               or edge_margin_px != 0.0)
    if generic:
        pw_s = (None if point_weights is None
                else sub(point_weights.to(pc.dtype), solver_stride))
        res = lm_solve_generic(pc_s, lab_s, val_s, K, theta0, t_lb, t_ub,
                               H=H, W=W, max_iter=max_iter, is_2d=is_2d,
                               outside_weight=outside_weight,
                               point_weights=pw_s,
                               edge_margin_px=float(edge_margin_px))
        thetas, costs = res.theta, res.cost
    else:
        # a multiple of I_BLK inits, padded by repeating the first (never a
        # new draw), as the JAX package's Pallas branch does
        pad = (-theta0.shape[1]) % I_BLK
        if pad:
            theta0 = torch.cat([theta0, theta0[:, :1].expand(-1, pad, -1)],
                               1)
        theta0 = theta0.contiguous()
        kw = dict(H=H, W=W)
        I = theta0.shape[1]
        probe_iter = min(8, max_iter)
        if max_iter > probe_iter and I >= 4 * I_BLK:
            ps = probe_stride
            thetas, costs = lm_solve(sub(pc_s, ps), sub(lab_s, ps),
                                     sub(val_s, ps), K, theta0, t_lb, t_ub,
                                     max_iter=probe_iter, **kw)
            keep = max((I // 8) // I_BLK * I_BLK, I_BLK)     # best eighth
            top = torch.argsort(costs, dim=1, stable=True)[:, :keep]
            theta_top = torch.gather(thetas, 1,
                                     top[:, :, None].expand(-1, -1, P_dim))
            thetas, costs = lm_solve(pc_s, lab_s, val_s, K,
                                     theta_top.contiguous(), t_lb, t_ub,
                                     max_iter=max_iter - probe_iter, **kw)
        else:
            thetas, costs = lm_solve(pc_s, lab_s, val_s, K, theta0, t_lb,
                                     t_ub, max_iter=max_iter, **kw)

    best = torch.argmin(costs, dim=1, keepdim=True)             # (B, 1)
    best_theta = torch.gather(thetas, 1,
                              best[:, :, None].expand(-1, -1, P_dim))
    best_theta = best_theta[:, 0]
    best_cost = torch.gather(costs, 1, best)[:, 0]
    P = theta_to_pose(best_theta, is_2d)
    has_inside = pred_inside.sum(dim=1) > 0
    eye = torch.eye(4, dtype=P.dtype, device=P.device).expand_as(P)
    P = torch.where(has_inside[:, None, None], P, eye)
    best_cost = torch.where(has_inside, best_cost,
                            torch.full_like(best_cost, 1e4))
    return P, best_cost
