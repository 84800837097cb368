"""Plain PyTorch reference of the ICP baseline (lijx10/DeepI2P
``evaluation/icp/registration_icp.py``, Open3D's point-to-point ICP): 30
iterations from each random (tx, tz, ry) init, correspondences by nearest
neighbour within 1 m, a weighted Kabsch step, fitness the share of source
points within 1 m of the target after the last step, the fittest init
flattened to a rotation about y (identity if its fitness is at most
0.001).

The nearest neighbour is found by ``|p|^2 - 2 q.p`` in blocks of queries
and its distance then taken directly; nothing of the program is imported.
``dtype`` is the precision of the points, distances and sums (the 3x3 SVD
runs in float32).
"""
from __future__ import annotations

import math

import torch

T_AMPLITUDE = (5.0, 0.0, 10.0)
RY_AMPLITUDE = math.pi
QUERY_BLOCK = 1 << 17


def rot_y(ry: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(ry), torch.sin(ry)
    z, o = torch.zeros_like(ry), torch.ones_like(ry)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def inits(generator: torch.Generator, B: int, n: int) -> torch.Tensor:
    """(B, n, 4, 4): ``ry ~ U(-1, 1) * 2 pi``, ``t ~ U(-1, 1) * (5, 0,
    10)``, drawn on the generator's device (yaws, then translations)."""
    kw = dict(generator=generator, device=generator.device)
    ry = (torch.rand(B, n, **kw) * 2.0 - 1.0) * RY_AMPLITUDE * 2.0
    t = (torch.rand(B, n, 3, **kw) * 2.0 - 1.0) * torch.tensor(
        T_AMPLITUDE, device=generator.device)
    P = torch.zeros(B, n, 4, 4, device=generator.device)
    P[..., :3, :3] = rot_y(ry)
    P[..., :3, 3] = t
    P[..., 3, 3] = 1.0
    return P


def nearest(q: torch.Tensor, db: torch.Tensor):
    """Squared distance and index of each query's nearest row: q (Q, 3),
    db (M, 3) -> ((Q,), (Q,))."""
    pn = (db * db).sum(-1)
    idx = torch.empty(q.shape[0], dtype=torch.long, device=q.device)
    for a in range(0, q.shape[0], QUERY_BLOCK):
        blk = torch.addmm(pn[None], q[a:a + QUERY_BLOCK], db.T, alpha=-2.0)
        idx[a:a + QUERY_BLOCK] = blk.argmin(dim=1)
    d2 = ((db[idx] - q) ** 2).sum(-1)
    return d2, idx


def icp(source, target, P0, *, iters: int, threshold: float,
        dtype=torch.float32):
    """Every init of one pair: source (N, 3), target (M, 3), P0 (I, 4, 4)
    -> (P (I, 4, 4) float32, fitness (I,))."""
    src = source.to(dtype)
    tgt = target.to(dtype)
    I, N = P0.shape[0], src.shape[0]
    R, t = P0[:, :3, :3].to(dtype), P0[:, :3, 3].to(dtype)

    def match(R, t):
        moved = torch.einsum("iab,nb->ina", R, src) + t[:, None]
        d2, idx = nearest(moved.reshape(-1, 3), tgt)
        return d2.reshape(I, N), idx.reshape(I, N)

    for _ in range(iters):
        d2, idx = match(R, t)
        w = (torch.sqrt(d2) < threshold).to(dtype)
        dst = tgt[idx]                                     # (I, N, 3)
        ws = torch.clamp(w.sum(-1), min=1e-6)[:, None]
        mu_s = (src[None] * w[..., None]).sum(1) / ws
        mu_d = (dst * w[..., None]).sum(1) / ws
        S = torch.einsum("in,ina,inb->iab", w, src[None] - mu_s[:, None],
                         dst - mu_d[:, None])
        U, _, Vh = torch.linalg.svd(S.float())
        V = Vh.mT
        D = torch.ones(I, 3, device=src.device)
        D[:, 2] = torch.linalg.det(V @ U.mT)
        Rn = ((V * D[:, None]) @ U.mT).to(dtype)
        tn = mu_d - torch.einsum("iab,ib->ia", Rn, mu_s)
        ok = w.sum(-1) >= 3
        R = torch.where(ok[:, None, None], Rn, R)
        t = torch.where(ok[:, None], tn, t)
    d2, _ = match(R, t)
    fitness = (d2.float() < threshold ** 2).float().mean(-1)
    P = torch.zeros(I, 4, 4, device=src.device)
    P[:, :3, :3], P[:, :3, 3], P[:, 3, 3] = R.float(), t.float(), 1.0
    return P, fitness


def flatten(P: torch.Tensor) -> torch.Tensor:
    """The rotation block replaced by the nearest rotation about y."""
    ry = torch.atan2(P[..., 0, 2] - P[..., 2, 0], P[..., 0, 0] + P[..., 2, 2])
    out = P.clone()
    out[..., :3, :3] = rot_y(ry)
    return out


def pick(P: torch.Tensor, fitness: torch.Tensor):
    """The fittest init, flattened; identity at fitness <= 0.001."""
    best = int(torch.argmax(fitness))
    Pb = flatten(P[best])
    if float(fitness[best]) <= 0.001:
        Pb = torch.eye(4, device=P.device)
    return Pb, fitness[best]
