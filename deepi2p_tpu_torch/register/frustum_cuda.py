"""The multi-init LM solve of the frustum cost: CUDA kernel wrapper and its
plain PyTorch version.

Counterpart of the JAX package's ``register/frustum_pallas.py``
(``lm_solve_pallas``) in both its modes: the 2-D mode (P = 4,
``theta = [ry, tx, ty, tz]``) and the 6-DoF mode (P = 6,
``theta = [rx, ry, rz, tx, ty, tz]``, angle-axis rotation).
:func:`lm_solve` sends CUDA tensors to the kernel (``csrc/frustum_lm.cu``)
and CPU tensors to :func:`lm_solve_plain`.

:func:`lm_solve_plain` is vectorised over (pairs, inits) and repeats the
kernel's arithmetic step for step: the same per-point expressions in the
same order, and every sum over points taken in the kernel's order.  For
P = 4 that is the cluster layout of :func:`lm_p4_plan`: C W virtual slices
of the points, each lane's points of a slice in turn, a 32-lane
butterfly, then the slices in turn (:func:`_cluster_sum`), with each
slice's inside-labelled points first when the kernel keeps them in shared
memory (:func:`_p4_point_order`).  For P = 6 it is 256 threads striding
over the points, a 32-lane butterfly in each warp, then the 8 warps in
turn (:func:`_block_sum`).  It has the Pallas kernel's carry semantics:
one sweep per iteration at the proposal, the carried H and g kept on a
rejected step.

The 6-DoF Jacobian is derived by hand (the Pallas kernel linearises with
``jax.linearize``): ``p = R(r) x + t`` with the rotation of
``_rot_entries`` (``frustum_pallas.py:144-167``), ``th = sqrt(|r|^2 +
1e-24)``, ``k = r / th``, ``R = c I + (1 - c) k k^T + s [k]x``, so

    dR/dr_j = dc I + d(1-c) k k^T + (1-c)(dk k^T + k dk^T) + ds [k]x
              + s [dk]x,
    dth = r_j / th,  dk_i = (delta_ij - k_i k_j) / th,
    dc = -s dth,  d(1-c) = s dth,  ds = c dth,

and ``dR/dr_j = [e_j]x`` in the first-order branch (``|r|^2 <= 1e-16``,
where ``R = I + [r]x``).  R and the three dR/dr_j depend on theta only,
so they are computed once per (init, sweep); per point
``dp/dr_j = (dR/dr_j) x`` and ``dp/dt_j = e_j``.  As in the Pallas 6-DoF
path, the residual rows and hence the Jacobian rows carry the point's
``valid`` factor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import _build

THREADS = 256        # the P = 6 kernel's block size (and its sum order)
WARP = 32
# The P = 4 kernel's launch (csrc/frustum_lm.cu, lm_p4_kernel): clusters of
# at most P4_MAX_CLUSTER blocks of G x W <= P4_MAX_WARPS warps; a block
# whose points number at most P4_TILE keeps them in shared memory.
P4_MAX_CLUSTER = 8
P4_MAX_WARPS = 16
P4_TILE = 5120
P4_TARGET_WARPS = 2048
# f32 operations per point per init per sweep, counted from the kernel's
# arithmetic (adds, multiplies, divides, compares, selects and each
# transcendental as one): projection and Jacobian ~35, residuals, signs
# and gates ~40, Jacobian selects ~15, robust weight and cost ~10, the 15
# weighted sums ~50.  The roofline bound of the chip check uses it.
LM_OPS_PER_POINT = 150
# The same count for the 6-DoF mode: the point p = R x + t 18, projection
# and its partials 11, dR/dr_j x for 3 rotation params 45, their pixel
# partials 18 and the tz ones 4, residuals, signs, gates and the valid
# factor 61, the 6 Jacobian columns 72, robust weight 7, the 21 H terms
# 126, the 6 g terms 36, the cost 3, the 28 running sums 28.
LM6_OPS_PER_POINT = 429


def lm_p4_plan(B: int, N: int, I: int) -> Tuple[int, int, int]:
    """(C, G, W) of the P = 4 kernel's launch for B pairs, N points and I
    inits: one cluster of C blocks per (pair, group of G inits), W warps
    per init in each block.

    Clusters of two blocks: the H100 places clusters of 4 or 8 blocks on
    only 124 of its 132 SMs, and a cluster barrier per sweep makes every
    cluster wait for its busiest SM, so blocks must spread evenly.  W
    doubles until the launch has :data:`P4_TARGET_WARPS` warps (about 16
    per SM), G = min(8, I, 16 / W), and C doubles only while a block's
    points would not fit shared memory.  The main path's probe (B=32,
    N=5120, I=64) gets (2, 8, 1), 512 blocks of 8 warps; its refine
    (N=10240, I=8) (2, 4, 4), 128 blocks of 16 warps, one per SM
    (``python -m deepi2p_tpu_torch.profile_lm_plans`` times the other
    plans)."""
    C, W = 2, 1
    while B * I * C * W < P4_TARGET_WARPS and W < P4_MAX_WARPS:
        W *= 2
    G = max(1, min(8, I, P4_MAX_WARPS // W))
    while not lm_p4_layout(N, C, W)[1] and C < P4_MAX_CLUSTER:
        C *= 2
    return C, G, W


def lm_p4_layout(N: int, C: int, W: int) -> Tuple[int, bool]:
    """(S, resident) of a P = 4 launch: the points are cut into C W
    virtual slices of S points (S a multiple of 32; the last ones short or
    empty), and a block's W S points stay in shared memory when they
    number at most :data:`P4_TILE`.  The kernel takes both from here and
    only checks them; the plain version sums in the same layout."""
    S = -(-N // (WARP * C * W)) * WARP
    return S, W * S <= P4_TILE


def _p4_point_order(labels: torch.Tensor, S: int) -> torch.Tensor:
    """(B, N) point order of a resident P = 4 launch: each virtual slice
    of S points with its inside-labelled points (label > 0.5) first, both
    groups in index order, as the kernel stages them."""
    N = labels.shape[1]
    pos = torch.arange(N, device=labels.device)
    key = (pos // S) * 2 + (~(labels > 0.5)).long()
    return torch.argsort(key, dim=1, stable=True)


def _cluster_sum(x: torch.Tensor, V: int, S: int) -> torch.Tensor:
    """Sum over the last axis in the P = 4 kernel's order for V = C W
    virtual slices of S points (:func:`lm_p4_layout`): each of a slice's
    32 lanes summing its points from 0 in increasing index, a butterfly
    over the lanes, then the slices in turn.  The zero padding adds +0 to
    sums that are never -0, so it changes nothing."""
    N = x.shape[-1]
    x = F.pad(x, (0, V * S - N))
    x = x.reshape(*x.shape[:-1], V, S // WARP, WARP)
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(S // WARP):
        acc = acc + x[..., j, :]
    off = WARP // 2
    while off >= 1:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    acc = acc[..., 0]                                  # (..., V)
    tot = acc[..., 0]
    for r in range(1, V):
        tot = tot + acc[..., r]
    return tot


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the P = 6 kernel's order."""
    N = x.shape[-1]
    rows = -(-N // THREADS)
    x = F.pad(x, (0, rows * THREADS - N))
    x = x.reshape(*x.shape[:-1], rows, THREADS)
    acc = x[..., 0, :]
    for r in range(1, rows):
        acc = acc + x[..., r, :]
    acc = acc.reshape(*acc.shape[:-1], THREADS // WARP, WARP)
    off = WARP // 2
    while off >= 1:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    acc = acc[..., 0]
    tot = acc[..., 0]
    for w in range(1, THREADS // WARP):
        tot = tot + acc[..., w]
    return tot


def _residual_parts(px, py, p2, H1: float, W1: float):
    """Residual hinges, their signs and the outside gate of a projected
    point (both modes)."""
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    r0_in = torch.maximum(-px, zero) + torch.maximum(px - W1, zero)
    s0 = (torch.where(px < 0, -1.0, 0.0)
          + torch.where(px > W1, 1.0, 0.0)).to(px.dtype)
    r1_in = torch.maximum(-py, zero) + torch.maximum(py - H1, zero)
    s1 = (torch.where(py < 0, -1.0, 0.0)
          + torch.where(py > H1, 1.0, 0.0)).to(px.dtype)
    r2_in = torch.maximum(-p2, zero) * 100.0
    s2 = torch.where(p2 < 0, -100.0, 0.0).to(px.dtype)

    hw, hh = W1 * 0.5, H1 * 0.5
    xd = hw - torch.abs(px - hw)
    yd = hh - torch.abs(py - hh)
    on = (p2 > 0) & (xd > 0) & (yd > 0)
    gate = on.to(px.dtype)
    # a select, not (xd + yd) * gate: at p2 == 0 exactly xd is -inf and the
    # product NaN, where the JAX package's compiled kernels give 0 (XLA
    # turns a product with a converted predicate into a select)
    r_out = torch.where(on, xd + yd, torch.zeros((), dtype=px.dtype,
                                                  device=px.device))
    sxd = (-torch.sign(px - hw)) * gate
    syd = (-torch.sign(py - hh)) * gate
    return r0_in, s0, r1_in, s1, r2_in, s2, r_out, sxd, syd, on


def _sweep(theta, xs, ys, zs, lab, val, fx, fy, cx, cy, H1: float,
           W1: float, V: int, S: int):
    """H (10 upper terms), g (4) and cost at theta, each (B, I), summed in
    the order of a launch with V = C W virtual slices of S points.

    theta (B, I, 4); xs..val (B, 1, N); fx..cy (B, 1, 1)."""
    ry = theta[..., 0:1]
    tx, ty, tz = theta[..., 1:2], theta[..., 2:3], theta[..., 3:4]
    c, s = torch.cos(ry), torch.sin(ry)
    p0 = c * xs + s * zs + tx
    p1 = ys + ty
    p2 = (-s) * xs + c * zs + tz
    inv_z = 1.0 / p2
    px = fx * p0 * inv_z + cx
    py = fy * p1 * inv_z + cy
    a = fx * inv_z
    b = fy * inv_z
    u = p0 * inv_z
    v = p1 * inv_z
    dry0 = p2 - tz
    dry2 = -(p0 - tx)
    dpx0 = a * (dry0 - u * dry2)
    dpx3 = (-a) * u
    dpy0 = b * ((-v) * dry2)
    dpy3 = (-b) * v

    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    r0_in, s0, r1_in, s1, r2_in, s2, r_out, sxd, syd, _ = _residual_parts(
        px, py, p2, H1, W1)

    inn = lab > 0.5
    r0 = torch.where(inn, r0_in, r_out)
    r1 = torch.where(inn, r1_in, zero)
    r2 = torch.where(inn, r2_in, zero)

    J00 = torch.where(inn, s0 * dpx0, sxd * dpx0 + syd * dpy0)
    J01 = torch.where(inn, s0 * a, sxd * a)
    J02 = torch.where(inn, zero, syd * b)
    J03 = torch.where(inn, s0 * dpx3, sxd * dpx3 + syd * dpy3)
    J10 = torch.where(inn, s1 * dpy0, zero)
    J12 = torch.where(inn, s1 * b, zero)
    J13 = torch.where(inn, s1 * dpy3, zero)
    J20 = torch.where(inn, s2 * dry2, zero)
    J23 = torch.where(inn, s2, zero)

    sb = r0 * r0 + r1 * r1 + r2 * r2
    w = val / (1.0 + sb)
    terms = torch.stack([
        w * (J00 * J00 + J10 * J10 + J20 * J20),
        w * (J00 * J01),
        w * (J00 * J02 + J10 * J12),
        w * (J00 * J03 + J10 * J13 + J20 * J23),
        w * (J01 * J01),
        w * (J01 * J02),
        w * (J01 * J03),
        w * (J02 * J02 + J12 * J12),
        w * (J02 * J03 + J12 * J13),
        w * (J03 * J03 + J13 * J13 + J23 * J23),
        w * (J00 * r0 + J10 * r1 + J20 * r2),
        w * (J01 * r0),
        w * (J02 * r0 + J12 * r1),
        w * (J03 * r0 + J13 * r1 + J23 * r2),
        0.5 * torch.log1p(sb) * val,
    ], dim=2)                                        # (B, I, 15, N)
    tot = _cluster_sum(terms, V, S)                  # (B, I, 15)
    return tot[..., :10], tot[..., 10:14], tot[..., 14]


def _skew(v):
    """Entries of [v]x, row-major (None for the structural zeros)."""
    return [None, -v[2], v[1], v[2], None, -v[0], -v[1], v[0], None]


def _rot6(theta):
    """R (9 entries, row-major) and dR/dr_j (3 x 9) of the angle-axis part
    of theta (B, I, 6), each (B, I, 1); the kernel's ``rot6``."""
    r = [theta[..., q:q + 1] for q in range(3)]
    t2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    th = torch.sqrt(t2 + 1e-24)
    s, c = torch.sin(th), torch.cos(th)
    k = [r[q] / th for q in range(3)]
    oc = 1.0 - c
    big = t2 > 1e-16
    one = torch.ones_like(th)
    Rb = [c + k[0] * k[0] * oc, k[0] * k[1] * oc - k[2] * s,
          k[0] * k[2] * oc + k[1] * s, k[1] * k[0] * oc + k[2] * s,
          c + k[1] * k[1] * oc, k[1] * k[2] * oc - k[0] * s,
          k[2] * k[0] * oc - k[1] * s, k[2] * k[1] * oc + k[0] * s,
          c + k[2] * k[2] * oc]
    Rs = [one, -r[2], r[1], r[2], one, -r[0], -r[1], r[0], one]
    R = [torch.where(big, a, b) for a, b in zip(Rb, Rs)]
    xk = _skew(k)
    dR = []
    for j in range(3):
        dth = r[j] / th
        dk = [((1.0 if i == j else 0.0) - k[i] * k[j]) / th
              for i in range(3)]
        dc = -(s * dth)
        doc = s * dth
        ds = c * dth
        xdk = _skew(dk)
        ej = [0.0, 0.0, 0.0]
        ej[j] = 1.0
        xe = _skew(ej)
        col = []
        for a in range(3):
            for b in range(3):
                v = doc * (k[a] * k[b]) + oc * (dk[a] * k[b] + k[a] * dk[b])
                if a == b:
                    v = dc + v
                    small = 0.0
                else:
                    v = v + (ds * xk[3 * a + b] + s * xdk[3 * a + b])
                    small = xe[3 * a + b]
                col.append(torch.where(big, v, small))
        dR.append(col)
    return R, dR


def _sweep6(theta, xs, ys, zs, lab, val, fx, fy, cx, cy, H1: float,
            W1: float):
    """H (21 upper terms), g (6) and cost at theta, each (B, I), 6-DoF.

    theta (B, I, 6); xs..val (B, 1, N); fx..cy (B, 1, 1)."""
    R, dR = _rot6(theta)
    tx, ty, tz = theta[..., 3:4], theta[..., 4:5], theta[..., 5:6]
    p0 = R[0] * xs + R[1] * ys + R[2] * zs + tx
    p1 = R[3] * xs + R[4] * ys + R[5] * zs + ty
    p2 = R[6] * xs + R[7] * ys + R[8] * zs + tz
    inv_z = 1.0 / p2
    px = fx * p0 * inv_z + cx
    py = fy * p1 * inv_z + cy
    a = fx * inv_z
    b = fy * inv_z
    u = p0 * inv_z
    v = p1 * inv_z
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    one = torch.ones((), dtype=xs.dtype, device=xs.device)
    dpx, dpy, dz = [], [], []
    for D in dR:
        q0 = D[0] * xs + D[1] * ys + D[2] * zs
        q1 = D[3] * xs + D[4] * ys + D[5] * zs
        q2 = D[6] * xs + D[7] * ys + D[8] * zs
        dpx.append(a * (q0 - u * q2))
        dpy.append(b * (q1 - v * q2))
        dz.append(q2)
    dpx += [a, zero, (-a) * u]
    dpy += [zero, b, (-b) * v]
    dz += [zero, zero, one]

    r0_in, s0, r1_in, s1, r2_in, s2, r_out, sxd, syd, on = _residual_parts(
        px, py, p2, H1, W1)
    inn = lab > 0.5
    r0 = torch.where(inn, r0_in, r_out) * val
    r1 = torch.where(inn, r1_in, zero) * val
    r2 = torch.where(inn, r2_in, zero) * val
    # the outside rows' derivative is selected by the gate as well (the
    # Pallas kernel's linearised r_out; the 2-D rows keep sxd * dpx, whose
    # 0 * inf at p2 == 0 is NaN in the JAX package too)
    J0 = [torch.where(inn, s0 * dpx[j],
                      torch.where(on, sxd * dpx[j] + syd * dpy[j], zero))
          * val for j in range(6)]
    J1 = [torch.where(inn, s1 * dpy[j], zero) * val for j in range(6)]
    J2 = [torch.where(inn, s2 * dz[j], zero) * val for j in range(6)]

    sb = r0 * r0 + r1 * r1 + r2 * r2
    w = val / (1.0 + sb)
    terms = [w * (J0[i] * J0[j] + J1[i] * J1[j] + J2[i] * J2[j])
             for i in range(6) for j in range(i, 6)]
    terms += [w * (J0[i] * r0 + J1[i] * r1 + J2[i] * r2) for i in range(6)]
    terms.append(0.5 * torch.log1p(sb) * val)
    shape = torch.broadcast_shapes(*(t.shape for t in terms))
    terms = torch.stack([t.expand(shape) for t in terms], dim=2)
    tot = _block_sum(terms)                          # (B, I, 28)
    return tot[..., :21], tot[..., 21:27], tot[..., 27]


def _upper(i: int, j: int, P: int = 4) -> int:
    """Index of H term (i, j), i <= j, in the order of the sweeps."""
    return i * P - i * (i - 1) // 2 + (j - i)


def _chol_solve(Hm: torch.Tensor, g: torch.Tensor, lam: torch.Tensor
                ) -> torch.Tensor:
    """Damped Cholesky solve, unrolled like the kernel's: Hm (..., P(P+1)/2),
    g (..., P), lam (...) -> delta (..., P)."""
    P = g.shape[-1]
    A = [Hm[..., q] for q in range(P * (P + 1) // 2)]
    for i in range(P):
        A[_upper(i, i, P)] = A[_upper(i, i, P)] * (1.0 + lam) + 1e-9
    L = {}
    for i in range(P):
        for j in range(i + 1):
            s = A[_upper(j, i, P)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            if i == j:
                L[(i, j)] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[(i, j)] = s / L[(j, j)]
    y = [None] * P
    for i in range(P):
        s = g[..., i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y[i] = s / L[(i, i)]
    x = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return torch.stack(x, dim=-1)


def _clip_t(theta: torch.Tensor, t_lb, t_ub) -> torch.Tensor:
    """Box-clip the translation, the last three parameters."""
    t_off = theta.shape[-1] - 3
    cols = [theta[..., q] for q in range(t_off)]
    for q in range(3):
        cols.append(torch.clamp(theta[..., t_off + q], min=float(t_lb[q]),
                                max=float(t_ub[q])))
    return torch.stack(cols, dim=-1)


def _check_inputs(pts, labels, valid, K, theta0):
    B, N, _ = pts.shape
    if theta0.dim() != 3 or theta0.shape[0] != B:
        raise ValueError(f"theta0 must be (B, I, P), got {tuple(theta0.shape)}")
    if theta0.shape[2] not in (4, 6):
        raise ValueError(
            f"theta0 must have P=4 (2-D: [ry, tx, ty, tz]) or P=6 (6-DoF: "
            f"[rx, ry, rz, tx, ty, tz]) parameters, got "
            f"{theta0.shape[2]}")
    for name, t, shape in (("pts", pts, (B, N, 3)), ("labels", labels, (B, N)),
                           ("valid", valid, (B, N)), ("K", K, (B, 3, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def lm_solve_plain(pts, labels, valid, K, theta0, t_lb, t_ub, *, H: int,
                   W: int, max_iter: int = 16, _plan=None):
    """Plain version of the LM kernel (any device; f32).

    Args as :func:`lm_solve`.  Returns (theta (B, I, P), cost (B, I)).
    ``_plan`` (P = 4; for tests and plan timings) replaces
    :func:`lm_p4_plan`'s (C, G, W), whose sum order is repeated."""
    _check_inputs(pts, labels, valid, K, theta0)
    f32 = torch.float32
    pts, labels, valid = pts.to(f32), labels.to(f32), valid.to(f32)
    if theta0.shape[2] == 4:
        C, _, warps = _plan or lm_p4_plan(pts.shape[0], pts.shape[1],
                                          theta0.shape[1])
        S, resident = lm_p4_layout(pts.shape[1], C, warps)
        if resident:
            order = _p4_point_order(labels, S)
            pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
            labels = torch.gather(labels, 1, order)
            valid = torch.gather(valid, 1, order)
        sweep_fn = functools.partial(_sweep, V=C * warps, S=S)
    else:
        sweep_fn = _sweep6
    xs, ys, zs = (pts[:, None, :, d] for d in range(3))        # (B, 1, N)
    lab, val = labels[:, None, :], valid[:, None, :]
    K = K.to(f32)
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    cx, cy = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    H1, W1 = float(H - 1), float(W - 1)

    def sweep(th):
        return sweep_fn(th, xs, ys, zs, lab, val, fx, fy, cx, cy, H1, W1)

    theta = _clip_t(theta0.to(f32), t_lb, t_ub)
    lam = torch.full(theta.shape[:2], 1e-3, dtype=f32, device=theta.device)
    Hm, g, cost = sweep(theta)
    for _ in range(max_iter):
        delta = _chol_solve(Hm, g, lam)
        prop = _clip_t(theta - delta, t_lb, t_ub)
        Hn, gn, cn = sweep(prop)
        acc = cn < cost
        theta = torch.where(acc[..., None], prop, theta)
        Hm = torch.where(acc[..., None], Hn, Hm)
        g = torch.where(acc[..., None], gn, g)
        cost = torch.where(acc, cn, cost)
        lam = torch.clamp(torch.where(acc, lam / 3.0, lam * 3.0),
                          min=1e-9, max=1e9)
    return theta, cost


def lm_solve_cuda(pts, labels, valid, K, theta0, t_lb, t_ub, *, H: int,
                  W: int, max_iter: int = 16, _plan=None):
    """The LM kernel on the card, in the mode of theta0's P (4 or 6).  All
    inputs f32, contiguous, on one CUDA device.  The P = 4 launch's layout
    is :func:`lm_p4_plan`'s and :func:`lm_p4_layout`'s; ``_plan`` (for
    tests and plan timings) replaces the (C, G, W).
    ``lm_solve_cuda.launches`` counts the launches of the 2-D mode,
    ``lm_solve_cuda.launches_p6`` those of the 6-DoF mode."""
    _check_inputs(pts, labels, valid, K, theta0)
    dev = pts.device
    for name, t in (("pts", pts), ("labels", labels), ("valid", valid),
                    ("K", K), ("theta0", theta0)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"lm_solve_cuda: {name} must be on the CUDA "
                             f"device of pts, is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"lm_solve_cuda: {name} must be float32")
        if not t.is_contiguous():
            raise ValueError(f"lm_solve_cuda: {name} must be contiguous")
    B, N, _ = pts.shape
    I, P = theta0.shape[1], theta0.shape[2]
    if not (0 < B <= 65535 and N > 0 and I > 0 and max_iter >= 0):
        raise ValueError(f"lm_solve_cuda: bad sizes B={B} N={N} I={I} "
                         f"max_iter={max_iter}")
    kparams = torch.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]],
                          dim=-1).contiguous()
    theta = torch.empty((B, I, P), dtype=torch.float32, device=dev)
    cost = torch.empty((B, I), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (pts.data_ptr(), labels.data_ptr(), valid.data_ptr(),
            kparams.data_ptr(), theta0.data_ptr(), theta.data_ptr(),
            cost.data_ptr(), B, N, I, int(max_iter), float(H - 1),
            float(W - 1), *(float(v) for v in t_lb),
            *(float(v) for v in t_ub))
    if P == 4:
        C, G, warps = _plan or lm_p4_plan(B, N, I)
        if not (1 <= C <= P4_MAX_CLUSTER and G >= 1 and warps >= 1
                and G * warps <= P4_MAX_WARPS):
            raise ValueError(f"lm_solve_cuda: plan (C={C}, G={G}, "
                             f"W={warps}) outside C<={P4_MAX_CLUSTER}, "
                             f"G*W<={P4_MAX_WARPS}")
        S, resident = lm_p4_layout(N, C, warps)
        name = "lm_solve_p4_f32"
        code = lib.lm_solve_p4_f32(*args, C, G, warps, S, int(resident),
                                   stream)
    else:
        name = "lm_solve_p6_f32"
        code = lib.lm_solve_p6_f32(*args, stream)
    _build.check(code, name)
    if P == 4:
        lm_solve_cuda.launches += 1
    else:
        lm_solve_cuda.launches_p6 += 1
    return theta, cost


lm_solve_cuda.launches = 0
lm_solve_cuda.launches_p6 = 0


def lm_p4_attrs() -> dict:
    """The built P = 4 kernel's registers per thread, static shared memory
    and spill bytes per thread, and its most threads per block."""
    buf = (ctypes.c_int * 4)()
    _build.check(_build.load_library().lm_p4_func_attrs(
        ctypes.addressof(buf)), "lm_p4_func_attrs")
    return dict(regs=buf[0], static_smem=buf[1], spill_bytes=buf[2],
                max_threads=buf[3])


def lm_p4_smem_bytes(N: int, C: int, W: int) -> int:
    """Dynamic shared memory of one block of a P = 4 launch: 20 bytes for
    each of its W S points when they stay there, else none."""
    S, resident = lm_p4_layout(N, C, W)
    return W * S * 20 if resident else 0


def lm_solve(pts, labels, valid, K, theta0, t_lb: Sequence[float],
             t_ub: Sequence[float], *, H: int, W: int, max_iter: int = 16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-init LM for a batch of pairs.

    Args:
      pts (B, N, 3); labels/valid (B, N); K (B, 3, 3); theta0 (B, I, P)
      as [ry, tx, ty, tz] (P = 4) or [rx, ry, rz, tx, ty, tz] (P = 6);
      t_lb/t_ub 3 translation bounds each.
    Returns:
      (theta (B, I, P), cost (B, I)), f32.
    """
    if pts.device.type == "cpu":
        return lm_solve_plain(pts, labels, valid, K, theta0, t_lb, t_ub,
                              H=H, W=W, max_iter=max_iter)
    return lm_solve_cuda(pts, labels, valid, K, theta0, t_lb, t_ub, H=H, W=W,
                         max_iter=max_iter)
