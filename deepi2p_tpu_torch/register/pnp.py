"""PnP registration over the fine labels, counterpart of the JAX package's
``register/pnp.py`` (``:35-286``; reference ``solve_PnP``,
``evaluation/registration_pnp.py:95-148``).

Points predicted inside the frustum are paired with the centre of their
predicted 1/32-resolution cell, and the pose comes from RANSAC PnP with a
0.6-cell reprojection threshold, 500 hypotheses and the reference's guards
(at least 4 inside points and 4 inliers, ``|t| < 14.14``, identity and
cost 1 otherwise).  As in the JAX package, every hypothesis is scored at
once: minimal sets of 8 inside points are drawn uniformly without
replacement, each is solved by DLT (inverse iteration on the 12x12 normal matrix
and a Newton polar factor), inliers are counted in one (hypothesis x
point) reprojection, the best 4 are polished by Gauss-Newton on their
inliers at 1.5, 1.25 and 1.0 times the threshold, and the raw best
hypothesis stays the fallback.  Here the batch of pairs and the
hypotheses are leading tensor axes.

Differences from the JAX package, none of which changes the result beyond
rounding:
- the JAX package draws each minimal set by a Gumbel top-k over the
  inside mask, (hypotheses x points) noise per pair; the port draws the
  same distribution, a uniform subset in a uniform order, from 8 uniforms
  per hypothesis of a torch CPU generator (:func:`draw_subsets`; the card
  and the CPU draw the same), or takes the sets from the caller
  (``subset=``, e.g. the top-k of JAX's own noise);
- the small SPD systems are factored once by an unrolled Cholesky with
  the JAX package's 1e-20 pivot floor and solved by ``cholesky_solve``.

Everything runs in f32 with TF32 off for the call (the JAX package pins
``Precision.HIGHEST``); the previous setting is restored on return.  The
JAX package's OpenCV oracle ``solve_pnp_cv2`` is not ported (OpenCV is a
test oracle there).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import span
from .frustum import rodrigues, skew

THRESH_STEPS = (1.5, 1.25, 1.0)   # LO polish thresholds, x reproj_thresh


class PnPResult(NamedTuple):
    P: torch.Tensor            # (..., 4, 4)
    cost: torch.Tensor         # outlier ratio, 1.0 on failure
    n_inliers: torch.Tensor


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fine_label_to_cell(fine_label: torch.Tensor, W_fine: int,
                       center: bool = False) -> torch.Tensor:
    """Fine label -> (x, y) cell coordinates (``registration_pnp.py:108-110``);
    ``center=True`` targets cell centres (+0.5), which the solver uses."""
    y = torch.div(fine_label, W_fine, rounding_mode="floor")
    uv = torch.stack([fine_label - y * W_fine, y], dim=-1).to(torch.float32)
    return uv + 0.5 if center else uv


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD (..., n, n), the JAX package's unrolled
    ``_spd_solve`` factorisation (``register/frustum.py:181``): sums in the
    same order, pivots floored at 1e-20 so it never fails."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j:j + 1, k]
        d = torch.sqrt(torch.clamp(s[..., :1], min=1e-20))
        L[..., j, j] = d[..., 0]
        L[..., j + 1:, j] = s[..., 1:] / d
    return L


def _spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``A x = b``: A (..., n, n), b (..., n)."""
    return torch.cholesky_solve(b[..., None], _cholesky(A))[..., 0]


def _smallest_eigvec(A: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of PSD (..., n, n) by inverse
    iteration with the shift ``1e-8 tr(A) / n`` (the JAX package's; not
    ``eigh``, whose sign and conditioning would part from it)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    shift = 1e-8 * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n
    L = _cholesky(A + shift[..., None, None] * eye)
    v = torch.full(A.shape[:-1], 1.0 / math.sqrt(n), dtype=A.dtype,
                   device=A.device)
    for _ in range(iters):
        w = torch.cholesky_solve(v[..., None], L)[..., 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                     keepdim=True),
                            min=1e-20)
    return v


def _det3(M: torch.Tensor) -> torch.Tensor:
    return torch.sum(M[..., :, 0] * torch.linalg.cross(M[..., :, 1],
                                                       M[..., :, 2]), -1)


def _orthogonalize(M: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Nearest rotation (polar factor) of (..., 3, 3) by the Newton
    iteration ``X <- (X + X^-T) / 2``, the sign fixed to det > 0 first."""
    M = M * torch.where(_det3(M) < 0, -1.0, 1.0)[..., None, None]
    fro = torch.sqrt(torch.sum(M * M, dim=(-2, -1)))
    X = M / torch.clamp(fro / math.sqrt(3.0), min=1e-20)[..., None, None]
    for _ in range(iters):
        c0 = torch.linalg.cross(X[..., :, 1], X[..., :, 2])
        c1 = torch.linalg.cross(X[..., :, 2], X[..., :, 0])
        c2 = torch.linalg.cross(X[..., :, 0], X[..., :, 1])
        det = torch.sum(X[..., :, 0] * c0, -1)
        det = torch.where(torch.abs(det) > 1e-20, det,
                          torch.full_like(det, 1e-20))
        X = 0.5 * (X + torch.stack([c0, c1, c2], dim=-1) / det[..., None,
                                                             None])
    return X


def _dlt_pose(X: torch.Tensor, uv: torch.Tensor, K_inv: torch.Tensor):
    """DLT pose from >= 6 2D-3D pairs with known intrinsics, Hartley
    normalised, cheirality enforced.  X (..., S, 3), uv (..., S, 2), K_inv
    broadcastable to (..., 3, 3) -> (R (..., 3, 3), t (..., 3))."""
    one = torch.ones_like(X[..., :1])
    xn = torch.cat([uv, one], -1) @ K_inv.transpose(-1, -2)
    u, v = xn[..., 0:1], xn[..., 1:2]
    mu = X.mean(dim=-2, keepdim=True)
    scale = math.sqrt(3.0) / torch.clamp(
        torch.linalg.vector_norm(X - mu, dim=-1).mean(-1), min=1e-6)
    Xh = torch.cat([(X - mu) * scale[..., None, None], one], -1)
    Z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, Z, -u * Xh], -1),
                   torch.cat([Z, Xh, -v * Xh], -1)], -2)      # (..., 2S, 12)
    m = _smallest_eigvec(A.transpose(-1, -2) @ A)
    m = m.reshape(*m.shape[:-1], 3, 4)
    # undo the normalisation: M' [sX; 1] == M [X; 1]
    mus = mu[..., 0, :] * scale[..., None]                    # (..., 3)
    m = torch.cat([m[..., :3] * scale[..., None, None],
                   (m[..., 3] - torch.sum(m[..., :3] * mus[..., None, :],
                                          -1))[..., None]], -1)
    depth = torch.sum(torch.cat([X, one], -1) * m[..., None, 2, :], -1)
    m = m * torch.where(depth.sum(-1) < 0, -1.0, 1.0)[..., None, None]
    M = m[..., :3]
    s = torch.pow(torch.clamp(torch.abs(_det3(M)), min=1e-20), 1.0 / 3.0)
    return _orthogonalize(M), m[..., 3] / s[..., None]


def _project(R, t, X, K):
    """Camera coordinates and pixels of X (..., N, 3) under (R, t):
    -> (px, py, z) each (..., N)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    cam = [R[..., k, 0, None] * x + R[..., k, 1, None] * y
           + R[..., k, 2, None] * z + t[..., k, None] for k in range(3)]
    zc = torch.clamp(cam[2], min=1e-6)
    px = K[..., 0, 0, None] * cam[0] / zc + K[..., 0, 2, None]
    py = K[..., 1, 1, None] * cam[1] / zc + K[..., 1, 2, None]
    return px, py, cam[2]


def _reproj_err(R, t, X, uv, K):
    """Pixel reprojection error (..., N); 1e6 behind the camera."""
    px, py, z = _project(R, t, X, K)
    err = torch.sqrt((px - uv[..., 0]) ** 2 + (py - uv[..., 1]) ** 2)
    return torch.where(z > 0, err, torch.full_like(err, 1e6))


def _rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> angle-axis (..., 3), safe for
    small angles."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)
    sin = torch.sin(theta)
    big = torch.abs(sin) > 1e-6
    axis = axis / torch.where(big, 2.0 * sin, torch.ones_like(sin))[..., None]
    return torch.where(big[..., None], axis * theta[..., None], axis * 0.5)


def _rodrigues_jac(aa: torch.Tensor):
    """:func:`rodrigues` of aa (..., 3) and its derivative dR (..., 3, 3,
    3), ``dR[..., j, :, :] = dR / d aa_j``, by hand: with ``theta =
    sqrt(|aa|^2 + 1e-24)``, ``k = aa / theta`` and ``R = I + s [k] + (1 -
    c) [k]^2``, ``d theta = k_j``, ``dk = (e_j - k k_j) / theta``, and
    ``dR = c k_j [k] + s [dk] + s k_j [k]^2 + (1 - c)([dk][k] + [k][dk])``;
    the first-order branch near zero (``R = I + [aa]``) has ``dR =
    [e_j]``.  What the JAX package's ``jacfwd`` takes of its
    ``rodrigues``, up to rounding.  (The 6-DoF LM's ``frustum_cuda._rot6``
    has the same derivative entry by entry, in the kernel's order: ~2.4x
    the polish's span here, 488 against 204 ms per KITTI batch of 8 on the
    H100.)"""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta2 + 1e-24)
    k = aa / theta[..., None]
    Kx = skew(k)
    KK = Kx @ Kx
    s = torch.sin(theta)[..., None, None, None]
    c = torch.cos(theta)[..., None, None, None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    dk = (eye - k[..., :, None] * k[..., None, :]) / theta[..., None, None]
    dKx = skew(dk)                                      # (..., 3, 3, 3)
    kj = k[..., :, None, None]
    Kx1, KK1 = Kx[..., None, :, :], KK[..., None, :, :]
    dR = (c * kj * Kx1 + s * dKx + s * kj * KK1
          + (1.0 - c) * (dKx @ Kx1 + Kx1 @ dKx))
    small = (theta2 <= 1e-16)[..., None, None, None]
    dR = torch.where(small, skew(eye).expand_as(dR), dR)
    return rodrigues(aa), dR


def _gn_refine(R0, t0, X, uv, K, weights, iters: int = 10):
    """Gauss-Newton polish of (R0, t0) (..., 3, 3) / (..., 3) on the
    weighted reprojection residuals of X (..., N, 3), weights (..., N),
    with ``H = J^T J + 1e-6 I`` over ``theta = [angle-axis, t]``.  The
    Jacobian is the JAX package's ``jacfwd`` of its residuals written out
    by hand (:func:`_rodrigues_jac` and the projection's chain rule): a
    few launches per iteration, where autodiff costs the host ~15 ms."""
    theta = torch.cat([_rotmat_to_aa(R0), t0], -1)
    eye3 = torch.eye(3, dtype=theta.dtype, device=theta.device)
    eye6 = torch.eye(6, dtype=theta.dtype, device=theta.device)
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    w = weights[..., None]
    for _ in range(iters):
        R, dR = _rodrigues_jac(theta[..., :3])
        cam = X @ R.transpose(-1, -2) + theta[..., None, 3:]  # (..., N, 3)
        live = (cam[..., 2] > 1e-6).to(cam.dtype)
        z = torch.clamp(cam[..., 2], min=1e-6)
        px, py = fx * cam[..., 0] / z, fy * cam[..., 1] / z
        r = torch.stack([px + cx - uv[..., 0], py + cy - uv[..., 1]], -1) * w
        dX = [X @ dR[..., j, :, :].transpose(-1, -2) for j in range(3)]
        dcam = torch.cat([torch.stack(dX, -1),
                          eye3.expand(*cam.shape, 3)], -1)    # (..., N, 3, 6)
        # d(px, py) / d cam = [[fx/z, 0, -px/z], [0, fy/z, -py/z]]
        dz = (dcam[..., 2, :] * live[..., None]) / z[..., None]
        J = torch.stack([(fx / z)[..., None] * dcam[..., 0, :]
                         - px[..., None] * dz,
                         (fy / z)[..., None] * dcam[..., 1, :]
                         - py[..., None] * dz], -2) * w[..., None]
        H = torch.einsum("...nrp,...nrq->...pq", J, J) + 1e-6 * eye6
        g = torch.einsum("...nrp,...nr->...p", J, r)
        theta = theta - _spd_solve(H, g)
    return rodrigues(theta[..., :3]), theta[..., 3:]


def _count(err, thresh, mask):
    return torch.sum((err < thresh).to(torch.float32) * mask, -1)


def _polish(R, t, X, uv, K, mask, thresh: float):
    """LO-RANSAC: inlier refits at shrinking thresholds, each kept when it
    does not lose inliers at ``thresh``.  -> (R, t, inliers)."""
    for step in THRESH_STEPS:
        err = _reproj_err(R, t, X, uv, K)
        with span("pnp.gn"):
            R_n, t_n = _gn_refine(R, t, X, uv, K,
                                  (err < step * thresh).to(torch.float32)
                                  * mask)
        better = (_count(_reproj_err(R_n, t_n, X, uv, K), thresh, mask)
                  >= _count(err, thresh, mask))
        R = torch.where(better[..., None, None], R_n, R)
        t = torch.where(better[..., None], t_n, t)
    return R, t, _count(_reproj_err(R, t, X, uv, K), thresh, mask)


def draw_subsets(generator: torch.Generator, mask: torch.Tensor,
                 n_hypotheses: int, size: int) -> torch.Tensor:
    """Minimal sets (B, n_hypotheses, size) of point indices for mask
    (B, N) {0,1}: each a uniform draw without replacement from the inside
    points, in a uniform order, as the JAX package's Gumbel top-k draws
    them; a pair with fewer inside points than ``size`` takes all of them
    and fills the set from its outside points the same way.  The draw is
    ``size`` f64 uniforms per hypothesis from ``generator`` on its own
    device, moved to ``mask``'s, so a CPU generator gives the same sets
    on every device.  Draw j picks the r-th of the ranks not yet taken,
    ``r = floor(u (pop - j))``."""
    B, N = mask.shape
    dev = mask.device
    u = torch.rand((B, n_hypotheses, size), generator=generator,
                   device=generator.device, dtype=torch.float64).to(dev)
    inside = mask > 0
    n_in = inside.sum(-1)[:, None, None]                       # (B, 1, 1)
    few = n_in < size
    pop = torch.where(few, N - n_in, n_in)
    drawn, taken = [], u.new_zeros((B, n_hypotheses, 0), dtype=torch.int64)
    for j in range(size):
        left = torch.clamp(pop - j, min=1)
        x = torch.minimum(torch.floor(u[..., j:j + 1] * left).to(torch.int64),
                          left - 1)
        for c in taken.unbind(-1):                             # ascending
            x = x + (c[..., None] <= x).to(torch.int64)
        drawn.append(x)
        taken = torch.sort(torch.cat([taken, x], -1), dim=-1).values
    ranks = torch.cat(drawn, -1)                               # (B, H, S)
    # too few inside: ranks 0..n_in-1 are the inside points, then the draws
    slot = torch.arange(size, device=dev)
    fill = torch.gather(ranks, -1, torch.clamp(slot - n_in, min=0)
                        .expand_as(ranks)) + n_in
    ranks = torch.where(few, torch.where(slot < n_in, slot, fill), ranks)
    order = torch.sort((~inside).to(torch.uint8), dim=-1,
                       stable=True).indices                    # inside first
    return torch.gather(order, 1, ranks.reshape(B, -1)).view_as(ranks)


def _take(x, idx):
    """x (B, H, ...) rows at idx (B, k) -> (B, k, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *[1] * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))


@torch.no_grad()
def solve_pnp_batch(pc, coarse_pred, fine_pred, K,
                    generator: Optional[torch.Generator] = None, *,
                    W_fine: int, n_hypotheses: int = 500,
                    reproj_thresh: float = 0.6, min_set: int = 8,
                    lo_candidates: int = 4, subset=None) -> PnPResult:
    """RANSAC PnP for a batch of pairs.

    Args:
      pc (B, N, 3), coarse_pred (B, N) {0,1}, fine_pred (B, N) cell labels,
      K (B, 3, 3) at full resolution (scaled to cell resolution here,
      ``registration_pnp.py:102-104``), all on one device.
      generator: draws the (B, n_hypotheses, min_set) minimal sets
        (:func:`draw_subsets`), unless ``subset`` gives them.
    Returns:
      PnPResult(P (B, 4, 4), cost (B,), n_inliers (B,)).
    """
    with _no_tf32():
        return _solve(pc, coarse_pred, fine_pred, K, generator, W_fine,
                      n_hypotheses, reproj_thresh, min_set, lo_candidates,
                      subset)


def solve_pnp(pc, coarse_pred, fine_pred, K,
              generator: Optional[torch.Generator] = None, *, W_fine: int,
              n_hypotheses: int = 500, reproj_thresh: float = 0.6,
              min_set: int = 8, lo_candidates: int = 4,
              subset=None) -> PnPResult:
    """:func:`solve_pnp_batch` for one pair: pc (N, 3), coarse_pred and
    fine_pred (N,), K (3, 3), ``subset`` (n_hypotheses, min_set)."""
    res = solve_pnp_batch(
        pc[None], coarse_pred[None], fine_pred[None], K[None], generator,
        W_fine=W_fine, n_hypotheses=n_hypotheses,
        reproj_thresh=reproj_thresh, min_set=min_set,
        lo_candidates=lo_candidates,
        subset=None if subset is None else torch.as_tensor(subset)[None])
    return PnPResult(*(x[0] for x in res))


def _solve(pc, coarse_pred, fine_pred, K, generator, W_fine, n_hypotheses,
           reproj_thresh, min_set, lo_candidates, subset):
    pc = torch.as_tensor(pc).to(torch.float32)
    dev = pc.device
    B = pc.shape[0]
    mask = torch.as_tensor(coarse_pred, device=dev).to(torch.float32)
    fine = torch.as_tensor(fine_pred, device=dev).to(torch.int64)
    K_fine = torch.as_tensor(K, device=dev).to(torch.float32) / 32.0
    K_fine[:, 2, 2] = 1.0
    K_inv = torch.linalg.inv(K_fine)
    uv = fine_label_to_cell(fine, W_fine, center=True)        # (B, N, 2)
    n_inside = mask.sum(-1)

    if subset is None:
        if generator is None:
            raise ValueError("need a generator when subset is not given")
        with span("pnp.draw"):
            subset = draw_subsets(generator, mask, n_hypotheses, min_set)
    subset = torch.as_tensor(subset, device=dev).to(torch.int64)  # (B, H, S)

    X, uvb, Kb = pc[:, None], uv[:, None], K_fine[:, None]
    with span("pnp.dlt"):
        flat = subset.reshape(B, -1)
        Rs, ts = _dlt_pose(_take(pc, flat).reshape(*subset.shape, 3),
                           _take(uv, flat).reshape(*subset.shape, 2),
                           K_inv[:, None])
    with span("pnp.reproj"):
        n_inl = _count(_reproj_err(Rs, ts, X, uvb, Kb), reproj_thresh,
                       mask[:, None])                         # (B, Hyp)
    # the best lo_candidates by inliers, ties to the lower index (top_k's)
    top = torch.sort(n_inl, dim=-1, descending=True,
                     stable=True).indices[:, :lo_candidates]
    with span("pnp.polish"):
        R_c, t_c, inl_c = _polish(_take(Rs, top), _take(ts, top), X, uvb,
                                  Kb, mask[:, None], reproj_thresh)
    ci = torch.argmax(inl_c, dim=-1, keepdim=True)
    R_f, t_f = _take(R_c, ci)[:, 0], _take(t_c, ci)[:, 0]
    inl_f = torch.gather(inl_c, 1, ci)[:, 0]
    # the raw best hypothesis if the polish lost inliers
    best = torch.argmax(n_inl, dim=-1, keepdim=True)
    inl_raw = torch.gather(n_inl, 1, best)[:, 0]
    use_raw = inl_raw > inl_f
    R_f = torch.where(use_raw[:, None, None], _take(Rs, best)[:, 0], R_f)
    t_f = torch.where(use_raw[:, None], _take(ts, best)[:, 0], t_f)
    inl_f = torch.maximum(inl_f, inl_raw)

    # guards (registration_pnp.py:123-146)
    ok = ((n_inside >= 4) & (torch.linalg.vector_norm(t_f, dim=-1) < 14.14)
          & (inl_f >= 4))
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(B, 4, 4)
    P = eye.clone()
    P[:, :3, :3] = R_f
    P[:, :3, 3] = t_f
    P = torch.where(ok[:, None, None], P, eye)
    cost = torch.where(ok, 1.0 - inl_f / torch.clamp(n_inside, min=1.0),
                       torch.ones_like(inl_f))
    return PnPResult(P=P, cost=cost, n_inliers=inl_f)
