"""Plain PyTorch reference of the frustum registration (lijx10/DeepI2P
``evaluation/frustum_reg/src/registration.cpp`` run over random inits by
``evaluation/registration_lsq.py``), in the 2-D mode ``theta = [ry, tx,
ty, tz]`` with the successive-halving budget of the main path: every init
for ``min(8, max_iter)`` iterations on every ``4 // solver_stride``-th
solver point, the best eighth (a multiple of 8, at least 8) for the rest
on every solver point, the cheapest kept.

The LM takes the Jacobian of the residuals by forward-mode autodiff and
solves the damped normal equations with ``torch.linalg.solve``; nothing
of the program is imported.  ``dtype`` is the precision of the residuals,
the Jacobian and every sum (the 4x4 solve itself runs in float32).
"""
from __future__ import annotations

import math

import torch

T_LB = (-5.0, -0.1, -10.0)
T_UB = (5.0, 0.1, 10.0)
# inits: ry ~ N(yaw guess, 10 deg), tz ~ U(-10, 10) (registration_lsq.py)
RY_SIGMA = 10.0 * math.pi / 180.0
INIT_T = 10.0
I_BLK = 8


def initial_guess(pc: torch.Tensor, pred: torch.Tensor):
    """Yaw towards the mean of the inside-labelled points and the mask of
    points no more than 10 m behind the nearest of them
    (``registration_lsq.py:196-220``).  pc (B,N,3), pred (B,N)."""
    m = pred.float()
    cnt = torch.clamp(m.sum(dim=1), min=1.0)
    mean = (pc * m[..., None]).sum(dim=1) / cnt[:, None]
    ang = torch.atan2(mean[:, 2], mean[:, 0]) - math.pi / 2
    ang = torch.remainder(ang + math.pi, 2 * math.pi) - math.pi
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    rot_z = -s * pc[..., 0] + c * pc[..., 2]
    min_in = torch.where(m > 0.5, rot_z, torch.inf).amin(dim=1)
    return ang, (rot_z > (min_in - 10.0)[:, None]).float()


def residuals(theta, pts, lab, K, H: int, W: int):
    """(B, I, 3, N) residual blocks of ``registration.cpp``: an inside
    label is pulled into the image and in front of the camera, an outside
    label that projects inside is pushed to the nearest image edge."""
    ry = theta[..., 0:1]
    c, s = torch.cos(ry), torch.sin(ry)
    x, y, z = (pts[:, None, :, d] for d in range(3))
    p0 = c * x + s * z + theta[..., 1:2]
    p1 = y + theta[..., 2:3]
    p2 = -s * x + c * z + theta[..., 3:4]
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    px = fx * p0 / p2 + cx
    py = fy * p1 / p2 + cy
    H1, W1 = H - 1.0, W - 1.0
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    r_in0 = torch.relu(-px) + torch.relu(px - W1)
    r_in1 = torch.relu(-py) + torch.relu(py - H1)
    r_in2 = torch.relu(-p2) * 100.0
    xd = W1 * 0.5 - torch.abs(px - W1 * 0.5)
    yd = H1 * 0.5 - torch.abs(py - H1 * 0.5)
    r_out = torch.where((p2 > 0) & (xd > 0) & (yd > 0), xd + yd, zero)
    inside = lab[:, None] > 0.5
    return torch.stack([torch.where(inside, r_in0, r_out),
                        torch.where(inside, r_in1, zero),
                        torch.where(inside, r_in2, zero)], dim=-2)


def cost(theta, pts, lab, val, K, H: int, W: int):
    """0.5 * sum over valid points of log(1 + |r|^2): (B, I)."""
    r = residuals(theta, pts, lab, K, H, W)
    return 0.5 * (torch.log1p((r * r).sum(dim=-2)) * val[:, None]).sum(-1)


def clip_t(theta):
    t = [torch.clamp(theta[..., 1 + q], T_LB[q], T_UB[q]) for q in range(3)]
    return torch.stack([theta[..., 0], *t], dim=-1)


def lm(pts, lab, val, K, theta0, *, H: int, W: int, max_iter: int,
       dtype=torch.float32):
    """Levenberg-Marquardt on the Cauchy-robustified cost from every init:
    IRLS weights ``1 / (1 + |r|^2)``, the diagonal damped by ``1 + lam``,
    a step kept only when it lowers the cost, ``lam`` divided or
    multiplied by 3 within [1e-9, 1e9].  -> (theta (B,I,4), cost (B,I))."""
    pts, lab, val, K = (t.to(dtype) for t in (pts, lab, val, K))
    eye = torch.eye(4, dtype=dtype, device=pts.device)

    def res(th):
        return residuals(th, pts, lab, K, H, W)

    def normal_eq(th):
        r = res(th)
        J = torch.stack([torch.func.jvp(res, (th,), (eye[j].expand_as(th),))[1]
                         for j in range(4)], dim=-1)        # (B,I,3,N,4)
        sb = (r * r).sum(dim=-2)                             # (B,I,N)
        w = val[:, None] / (1.0 + sb)
        Jw = J * w[..., None, :, None]
        Hm = torch.einsum("birnp,birnq->bipq", Jw, J)
        g = torch.einsum("birnp,birn->bip", Jw, r)
        c = 0.5 * (torch.log1p(sb) * val[:, None]).sum(-1)
        return Hm, g, c

    theta = clip_t(theta0.to(dtype))
    lam = torch.full(theta.shape[:2], 1e-3, dtype=torch.float32,
                     device=pts.device)
    Hm, g, c = normal_eq(theta)
    for _ in range(max_iter):
        A = Hm.float() + torch.diag_embed(
            torch.diagonal(Hm.float(), dim1=-2, dim2=-1) * lam[..., None]
            + 1e-9)
        delta = torch.linalg.solve(A, g.float()[..., None])[..., 0]
        prop = clip_t(theta - delta.to(dtype))
        Hn, gn, cn = normal_eq(prop)
        acc = cn < c
        theta = torch.where(acc[..., None], prop, theta)
        Hm = torch.where(acc[..., None, None], Hn, Hm)
        g = torch.where(acc[..., None], gn, g)
        c = torch.where(acc, cn, c)
        lam = torch.clamp(torch.where(acc, lam / 3.0, lam * 3.0), 1e-9, 1e9)
    return theta, c


def pose(theta) -> torch.Tensor:
    """(..., 4) -> (..., 4, 4): rotation about y by ry, translation t."""
    ry = theta[..., 0]
    c, s = torch.cos(ry), torch.sin(ry)
    P = torch.zeros(*theta.shape[:-1], 4, 4, dtype=theta.dtype,
                    device=theta.device)
    P[..., 0, 0], P[..., 0, 2] = c, s
    P[..., 1, 1] = 1.0
    P[..., 2, 0], P[..., 2, 2] = -s, c
    P[..., :3, 3] = theta[..., 1:4]
    P[..., 3, 3] = 1.0
    return P


def theta_of(P: torch.Tensor) -> torch.Tensor:
    """The 2-D parameters of poses (..., 4, 4) built by :func:`pose`."""
    ry = torch.atan2(P[..., 0, 2], P[..., 0, 0])
    return torch.cat([ry[..., None], P[..., :3, 3]], dim=-1)


def solve(pc, pred, K, theta0, *, H: int, W: int, max_iter: int,
          solver_stride: int, dtype=torch.float32):
    """The multi-init solve from the inits ``theta0`` (B, I, 4):
    (P (B,4,4), cost (B,)); a pair with no inside label gets the identity
    and cost 1e4."""
    pc = pc.float()
    _, valid = initial_guess(pc, pred)
    lab = pred.float()
    pts, lab_s, val_s = (x[:, ::solver_stride] for x in (pc, lab, valid))
    pad = (-theta0.shape[1]) % I_BLK
    if pad:
        theta0 = torch.cat([theta0, theta0[:, :1].expand(-1, pad, -1)], 1)
    I = theta0.shape[1]
    probe = min(8, max_iter)
    kw = dict(H=H, W=W, dtype=dtype)
    if max_iter > probe and I >= 4 * I_BLK:
        ps = max(1, 4 // solver_stride)
        th, c = lm(pts[:, ::ps], lab_s[:, ::ps], val_s[:, ::ps], K, theta0,
                   max_iter=probe, **kw)
        keep = max(I // 8 // I_BLK * I_BLK, I_BLK)
        top = torch.argsort(c.float(), dim=1, stable=True)[:, :keep]
        th = torch.gather(th, 1, top[..., None].expand(-1, -1, 4))
        th, c = lm(pts, lab_s, val_s, K, th, max_iter=max_iter - probe, **kw)
    else:
        th, c = lm(pts, lab_s, val_s, K, theta0, max_iter=max_iter, **kw)
    best = torch.argmin(c.float(), dim=1)
    ar = torch.arange(pc.shape[0], device=pc.device)
    P = pose(th[ar, best].float())
    c_best = c[ar, best].float()
    has = pred.sum(dim=1) > 0
    P = torch.where(has[:, None, None], P, torch.eye(4, device=pc.device))
    return P, torch.where(has, c_best, torch.full_like(c_best, 1e4))


def cost_at(P, pc, pred, K, *, H: int, W: int, solver_stride: int):
    """The cost (B,) of poses P (B, 4, 4) on the solver's points, float32."""
    pc = pc.float()
    _, valid = initial_guess(pc, pred)
    s = solver_stride
    return cost(theta_of(P.float())[:, None], pc[:, ::s], pred.float()[:, ::s],
                valid[:, ::s], K.float(), H, W)[:, 0]
