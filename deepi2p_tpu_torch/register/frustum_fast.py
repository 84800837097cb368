"""Analytic-Jacobian LM for the frustum cost (2-D mode), counterpart of
the JAX package's ``register/frustum_fast.py``.

The Jacobian of the residuals with respect to ``theta = [ry, tx, ty, tz]``
is written in closed form and the 4x4 normal equations are summed
directly, batched over (pairs x inits).  Per point, with the camera model
``px = fx p0 / p2 + cx``:

    p = Ry(ry) x + t  =>  dp/dry = (p2 - tz, 0, -(p0 - tx)),  dp/dt = I
    dpx/dtheta = a (dp0/dtheta - (p0/p2) dp2/dtheta),  a = fx / p2
    dpy/dtheta = b (dp1/dtheta - (p1/p2) dp2/dtheta),  b = fy / p2

an inside-labelled point has the three hinge residuals (gates in
{-1, 0, 1}, and -100 on the depth), an outside-labelled one the single
``(xd + yd) * gate`` residual whose derivative along ``px`` is
``-sign(px - W1/2)`` (the reference's cost, ``registration_2d.hpp:52-62,
123-127``).

This is plain PyTorch on every device: the JAX package computes it in
XLA, not in Pallas, so it has no kernel.  :func:`lm_solve_fast` keeps the
JAX solver's fixed iteration count with a per-problem ``active`` mask, so
its answer does not depend on how many problems share a batch.
"""
from __future__ import annotations

import torch

from .frustum_cuda import _chol_solve, _clip_t, _residual_parts


def _forward(theta, xs, ys, zs, fx, fy, cx, cy):
    """theta (..., 4); xs/ys/zs (..., N); intrinsics (..., 1)."""
    ry = theta[..., 0:1]
    tx, ty, tz = theta[..., 1:2], theta[..., 2:3], theta[..., 3:4]
    c, s = torch.cos(ry), torch.sin(ry)
    p0 = c * xs + s * zs + tx
    p1 = ys + ty
    p2 = (-s) * xs + c * zs + tz
    px = fx * p0 / p2 + cx
    py = fy * p1 / p2 + cy
    return p0, p1, p2, px, py


def _residual_cost(theta, xs, ys, zs, labels, valid, fx, fy, cx, cy,
                   H1: float, W1: float):
    """Cauchy-robustified block cost, shape (...,)."""
    _, _, p2, px, py = _forward(theta, xs, ys, zs, fx, fy, cx, cy)
    r0_in, _, r1_in, _, r2_in, _, r_out, _, _, _ = _residual_parts(
        px, py, p2, H1, W1)
    s = torch.where(labels > 0.5, r0_in ** 2 + r1_in ** 2 + r2_in ** 2,
                    r_out ** 2)
    return 0.5 * torch.sum(torch.log1p(s) * valid, dim=-1)


def _normal_equations(theta, xs, ys, zs, labels, valid, fx, fy, cx, cy,
                      H1: float, W1: float):
    """One pass -> (H (..., 4, 4), g (..., 4), cost (...,))."""
    tx, tz = theta[..., 1:2], theta[..., 3:4]
    p0, p1, p2, px, py = _forward(theta, xs, ys, zs, fx, fy, cx, cy)
    inv_z = 1.0 / p2
    a = fx * inv_z
    b = fy * inv_z
    u = p0 * inv_z
    v = p1 * inv_z
    dry0 = p2 - tz
    dry2 = -(p0 - tx)
    zero_t = torch.zeros_like(a)
    # pixel and depth derivative rows, one (..., N) tensor per parameter
    dpx = (a * (dry0 - u * dry2), a, zero_t, (-a) * u)
    dpy = (b * ((-v) * dry2), zero_t, b, (-b) * v)
    dz = (dry2, zero_t, zero_t, torch.ones_like(a))

    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    # hinges, their gate signs and the outside residual with its sign
    # derivatives (shared with the LM kernel's plain version)
    r0_in, s0, r1_in, s1, r2_in, s2, r_out, sxd, syd, _ = _residual_parts(
        px, py, p2, H1, W1)

    is_in = labels > 0.5
    r0 = torch.where(is_in, r0_in, r_out)
    r1 = torch.where(is_in, r1_in, zero)
    r2 = torch.where(is_in, r2_in, zero)
    s_blk = r0 ** 2 + r1 ** 2 + r2 ** 2
    w = valid / (1.0 + s_blk)                     # Cauchy rho'
    cost = 0.5 * torch.sum(torch.log1p(s_blk) * valid, dim=-1)

    # Jacobian rows per point: inside s0*dpx, s1*dpy, s2*dz; outside the
    # one row sxd*dpx + syd*dpy
    J0 = [torch.where(is_in, s0 * dx, sxd * dx + syd * dy)
          for dx, dy in zip(dpx, dpy)]
    J1 = [torch.where(is_in, s1 * dy, zero) for dy in dpy]
    J2 = [torch.where(is_in, s2 * dzk, zero) for dzk in dz]

    g = torch.stack([torch.sum(w * (J0[k] * r0 + J1[k] * r1 + J2[k] * r2),
                               dim=-1) for k in range(4)], dim=-1)
    ent = {}
    for i in range(4):
        for j in range(i, 4):
            ent[(i, j)] = torch.sum(
                w * (J0[i] * J0[j] + J1[i] * J1[j] + J2[i] * J2[j]), dim=-1)
    Hmat = torch.stack([torch.stack([ent[(min(i, j), max(i, j))]
                                     for j in range(4)], dim=-1)
                        for i in range(4)], dim=-2)
    return Hmat, g, cost


def lm_solve_fast(pts, labels, valid, K, theta0, t_lb, t_ub, *, H: int,
                  W: int, max_iter: int = 32):
    """Batched analytic-Jacobian LM (2-D mode), the JAX package's
    ``lm_solve_fast``.

    Args:
      pts (B, N, 3); labels/valid (B, N); K (B, 3, 3); theta0 (B, I, 4);
      t_lb/t_ub three translation bounds each; all on one device.
    Returns:
      (theta (B, I, 4), cost (B, I), n_accepted (B, I) int32), f32.

    Every iteration solves the damped normal equations (``lam`` from
    1e-3, divided by 3 on an accepted step and multiplied by 3 on a
    rejected one, clipped to [1e-9, 1e9]) and clips t to its bounds.  A
    problem goes inactive once an accepted step improves its cost by less
    than 1e-6 relative, or once rejections push ``lam`` to 1e6."""
    f32 = torch.float32
    pts, labels, valid = pts.to(f32), labels.to(f32), valid.to(f32)
    K, theta0 = K.to(f32), theta0.to(f32)
    B, I, _ = theta0.shape
    xs, ys, zs = (pts[:, None, :, d] for d in range(3))        # (B, 1, N)
    lab, val = labels[:, None, :], valid[:, None, :]
    fx, fy = K[:, None, 0:1, 0], K[:, None, 1:2, 1]            # (B, 1, 1)
    cx, cy = K[:, None, 0:1, 2], K[:, None, 1:2, 2]
    # the reference passes H_1 = H-1, W_1 = W-1 (registration.cpp:21-22)
    H1, W1 = float(H - 1), float(W - 1)

    def cost_fn(theta):
        return _residual_cost(theta, xs, ys, zs, lab, val, fx, fy, cx, cy,
                              H1, W1)

    upper = [(i, j) for i in range(4) for j in range(i, 4)]
    theta = _clip_t(theta0, t_lb, t_ub)
    lam = torch.full((B, I), 1e-3, dtype=f32, device=theta.device)
    cost = cost_fn(theta)
    n_acc = torch.zeros((B, I), dtype=torch.int32, device=theta.device)
    active = torch.ones((B, I), dtype=torch.bool, device=theta.device)
    three = torch.full_like(lam, 3.0)
    for _ in range(max_iter):
        Hmat, g, _ = _normal_equations(theta, xs, ys, zs, lab, val, fx, fy,
                                       cx, cy, H1, W1)
        Hm = torch.stack([Hmat[..., i, j] for i, j in upper], dim=-1)
        theta_new = _clip_t(theta - _chol_solve(Hm, g, lam), t_lb, t_ub)
        new_cost = cost_fn(theta_new)
        accept = (new_cost < cost) & active
        improved = (cost - new_cost) > 1e-6 * torch.clamp(cost, min=1e-12)
        theta = torch.where(accept[..., None], theta_new, theta)
        cost = torch.where(accept, new_cost, cost)
        # a true division, as on the CPU: PyTorch on the card multiplies
        # by the reciprocal of a Python scalar divisor
        lam = torch.clamp(torch.where(accept, lam / three,
                                      torch.where(active, lam * 3.0, lam)),
                          min=1e-9, max=1e9)
        active = active & torch.where(accept, improved, lam < 1e6)
        n_acc = n_acc + accept.to(torch.int32)
    return theta, cost, n_acc
