"""The benchmark's traffic: seeded synthetic registration pairs (numpy).

A frozen copy of the port's ``deepi2p_tpu_torch/data/synthetic.py``
(``_random_pose``, ``_street_scene``, ``raycast_street_depth``,
``synthetic_batch``) and of the ICP harness's pseudo-cloud preparation
(``register/icp.py::depth_to_pointcloud`` and the depth-scale calibration of
``eval/harness.py``), so that no later change to the program moves the
benchmark's inputs.  It reads a configuration as a plain dict (the keys of
``portbench/configs/*.json``) and imports nothing of the program.

:func:`pool` is the one generator every cell uses: ``pool`` distinct
batches of ``batch`` pairs, batch ``i`` from the seed ``(seed, i)``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def derived_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed drawn from ``(seed, *tags)``: any whole ``seed``, also
    one over 32 bits, gives independent streams per tag."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _random_pose(rng: np.random.Generator, cfg: dict) -> np.ndarray:
    ax = rng.uniform(-cfg["P_Rx_amplitude"], cfg["P_Rx_amplitude"])
    ay = rng.uniform(-cfg["P_Ry_amplitude"], cfg["P_Ry_amplitude"])
    az = rng.uniform(-cfg["P_Rz_amplitude"], cfg["P_Rz_amplitude"])
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    t = np.array([rng.uniform(-cfg["P_tx_amplitude"], cfg["P_tx_amplitude"]),
                  rng.uniform(-cfg["P_ty_amplitude"], cfg["P_ty_amplitude"]),
                  rng.uniform(-cfg["P_tz_amplitude"], cfg["P_tz_amplitude"])])
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = R.astype(np.float32)
    P[:3, 3] = t.astype(np.float32)
    return P


def _street_scene(rng: np.random.Generator, n: int):
    """Points on a ground plane, two facades and six boxes, with normals
    and per-surface reflectance, and the analytic surfaces."""
    n_g = int(n * 0.4)
    n_f = int(n * 0.4)
    n_b = n - n_g - n_f
    g = np.stack([rng.uniform(-30, 30, n_g),
                  2.0 + rng.normal(0, 0.05, n_g),
                  rng.uniform(-40, 40, n_g)], axis=-1)
    g_n = np.tile(np.array([0.0, -1.0, 0.0]), (n_g, 1))
    g_i = rng.uniform(0.05, 0.25) + rng.normal(0, 0.04, n_g)
    wl, wr = rng.uniform(8, 16), rng.uniform(8, 16)
    left = rng.random(n_f) < 0.5
    x = np.where(left, -wl, wr) + rng.normal(0, 0.05, n_f)
    fz = rng.uniform(-40, 40, n_f)
    f = np.stack([x, rng.uniform(-6, 2, n_f), fz], axis=-1)
    f_n = np.stack([np.where(left, 1.0, -1.0), np.zeros(n_f),
                    np.zeros(n_f)], axis=-1)
    seg_len = rng.uniform(8.0, 15.0)
    seg_phase = rng.uniform(0.0, seg_len)
    seg = np.floor((fz + 40.0 + seg_phase) / seg_len).astype(int) \
        + 16 * left.astype(int)
    seg_levels = rng.uniform(0.3, 1.0, 48)
    f_i = seg_levels[seg % 48] + rng.normal(0, 0.04, n_f)
    nbox = 6
    centers = np.stack([rng.uniform(-6, 6, nbox),
                        np.full(nbox, 1.0),
                        rng.uniform(-35, 35, nbox)], axis=-1)
    sizes = rng.uniform(1.5, 4.0, (nbox, 3))
    box_levels = rng.uniform(0.3, 1.0, nbox)
    bi = rng.integers(0, nbox, n_b)
    local = rng.uniform(-0.5, 0.5, (n_b, 3))
    face_ax = np.argmax(np.abs(local), axis=1)
    onehot = np.eye(3)[face_ax]
    sign = np.sign(local[np.arange(n_b), face_ax])[:, None]
    local = local * (1.0 - onehot) + 0.5 * sign * onehot
    b = centers[bi] + local * sizes[bi]
    b_n = (sign * onehot).astype(np.float64)
    b_i = box_levels[bi] + rng.normal(0, 0.04, n_b)
    pc = np.concatenate([g, f, b]).astype(np.float32)
    sn = np.concatenate([g_n, f_n, b_n]).astype(np.float32)
    inten = np.clip(np.concatenate([g_i, f_i, b_i]), 0.0, 1.0)
    inten = inten.astype(np.float32)[:, None]
    perm = rng.permutation(n)
    scene = dict(wl=float(wl), wr=float(wr), ground_y=2.0,
                 ground_x=30.0, zmax=40.0, facade_ymin=-6.0,
                 facade_ymax=2.0, box_min=(centers - 0.5 * sizes),
                 box_max=(centers + 0.5 * sizes))
    return pc[perm], sn[perm], inten[perm], scene


def raycast_street_depth(scene: dict, P: np.ndarray, K: np.ndarray,
                         H: int, W: int, far: float = 88.0) -> np.ndarray:
    """Dense depth (H, W) float32 of a street scene by ray casting its
    analytic surfaces; rays that leave the scene read ``far``."""
    R, t = np.asarray(P[:3, :3], np.float64), np.asarray(P[:3, 3],
                                                         np.float64)
    C = -R.T @ t
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64) + 0.5,
                         np.arange(H, dtype=np.float64) + 0.5)
    dir_c = np.stack([(us - K[0, 2]) / K[0, 0],
                      (vs - K[1, 2]) / K[1, 1],
                      np.ones_like(us)], axis=-1).reshape(-1, 3)
    d = dir_c @ R
    eps = 1e-12
    best = np.full(d.shape[0], np.inf)

    def consider(s, valid):
        nonlocal best
        ok = valid & (s > 0.1)
        best = np.where(ok & (s < best), s, best)

    den = d[:, 1]
    s = (scene["ground_y"] - C[1]) / np.where(np.abs(den) < eps, eps, den)
    hit = C[None] + s[:, None] * d
    consider(s, (np.abs(den) >= eps) & (np.abs(hit[:, 0]) <= scene["ground_x"])
             & (np.abs(hit[:, 2]) <= scene["zmax"]))
    for x0 in (-scene["wl"], scene["wr"]):
        den = d[:, 0]
        s = (x0 - C[0]) / np.where(np.abs(den) < eps, eps, den)
        hit = C[None] + s[:, None] * d
        consider(s, (np.abs(den) >= eps)
                 & (hit[:, 1] >= scene["facade_ymin"])
                 & (hit[:, 1] <= scene["facade_ymax"])
                 & (np.abs(hit[:, 2]) <= scene["zmax"]))
    safe_d = np.where(np.abs(d) < eps, eps, d)
    for bmin, bmax in zip(scene["box_min"], scene["box_max"]):
        t0 = (bmin[None] - C[None]) / safe_d
        t1 = (bmax[None] - C[None]) / safe_d
        tnear = np.max(np.minimum(t0, t1), axis=1)
        tfar = np.min(np.maximum(t0, t1), axis=1)
        consider(tnear, tnear <= tfar)

    depth = np.where(np.isfinite(best), best, far)
    return np.minimum(depth, far).reshape(H, W).astype(np.float32)


def synthetic_batch(cfg: dict, batch_size: int, seed: int, scene: str,
                    dense_depth: bool = False) -> Dict[str, np.ndarray]:
    """One batch of ``batch_size`` pairs: the cloud (pc, intensity, sn),
    SOM nodes drawn from it, the pose P, intrinsics K and the rendered
    image; ``dense_depth`` (street scenes) adds the ray-cast ``depth``."""
    rng = np.random.default_rng(seed)
    B = batch_size
    N, Ma, Mb = cfg["input_pt_num"], cfg["node_a_num"], cfg["node_b_num"]
    H, W = cfg["img_H"], cfg["img_W"]

    scenes = None
    if scene == "street":
        clouds = [_street_scene(rng, N) for _ in range(B)]
        pc = np.stack([c[0] for c in clouds])
        sn = np.stack([c[1] for c in clouds])
        intensity = np.stack([c[2] for c in clouds])
        scenes = [c[3] for c in clouds]
    elif scene == "uniform":
        pc = np.stack([rng.uniform(-30, 30, (B, N)),
                       rng.uniform(-5, 5, (B, N)),
                       rng.uniform(-10, 40, (B, N))],
                      axis=-1).astype(np.float32)
        sn = rng.normal(size=(B, N, 3)).astype(np.float32)
        sn /= np.linalg.norm(sn, axis=-1, keepdims=True)
        intensity = rng.uniform(0, 1, (B, N, 1)).astype(np.float32)
    else:
        raise ValueError(f"unknown scene {scene!r}")

    P = np.stack([_random_pose(rng, cfg)[:3] for _ in range(B)])
    node_idx_a = rng.choice(N, (B, Ma))
    node_idx_b = rng.choice(N, (B, Mb))
    node_a = np.take_along_axis(pc, node_idx_a[..., None], axis=1)
    node_b = np.take_along_axis(pc, node_idx_b[..., None], axis=1)
    f = 0.6 * W
    K = np.tile(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    img = rng.uniform(0, 60, (B, H, W, 3)).astype(np.float32)
    for b in range(B):
        cam = pc[b] @ P[b, :3, :3].T + P[b, :3, 3]
        z = cam[:, 2]
        front = z > 0.1
        u = (K[b, 0, 0] * cam[:, 0] / np.where(front, z, 1.0)
             + K[b, 0, 2]).astype(np.int32)
        v = (K[b, 1, 1] * cam[:, 1] / np.where(front, z, 1.0)
             + K[b, 1, 2]).astype(np.int32)
        m = front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        order = np.argsort(-z[m], kind="stable")
        vi, ui, zi = v[m][order], u[m][order], z[m][order]
        ii = intensity[b, :, 0][m][order]
        img[b, vi, ui, 0] = np.clip(255.0 * 5.0 / np.maximum(zi, 1.0), 0, 255)
        img[b, vi, ui, 1] = ii * 255.0
        img[b, vi, ui, 2] = 128.0
    out = dict(pc=pc, intensity=intensity, sn=sn, node_a=node_a,
               node_b=node_b, P=P.astype(np.float32), img=img, K=K)
    if dense_depth:
        if scenes is None:
            raise ValueError("dense depth needs street scenes")
        out["depth"] = np.stack([raycast_street_depth(
            scenes[b], P[b], K[b], H, W) for b in range(B)])
    return out


def pseudo_clouds(batch: Dict[str, np.ndarray], stride: int) -> np.ndarray:
    """(B, M, 3) camera-frame clouds from the dense depth at ``stride``,
    each scaled so its mean depth is that of the pair's points inside the
    true frustum (the ICP harness's calibration)."""
    out = []
    for b in range(batch["pc"].shape[0]):
        depth, K = batch["depth"][b], batch["K"][b]
        H, W = depth.shape
        d = depth[::stride, ::stride]
        ys, xs = np.meshgrid(np.arange(0, H, stride, dtype=np.float32),
                             np.arange(0, W, stride, dtype=np.float32),
                             indexing="ij")
        x = (xs - K[0, 2]) / K[0, 0] * d
        y = (ys - K[1, 2]) / K[1, 1] * d
        pseudo = np.stack([x, y, d], axis=-1).reshape(-1, 3)
        P = batch["P"][b]
        cam = batch["pc"][b] @ P[:3, :3].T + P[:3, 3]
        px = K[0, 0] * cam[:, 0] / cam[:, 2] + K[0, 2]
        py = K[1, 1] * cam[:, 1] / cam[:, 2] + K[1, 2]
        inside = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
                  & (cam[:, 2] > 0.1)).astype(np.float32)
        mean_gt = np.sum(cam[:, 2] * inside) / max(np.sum(inside), 1.0)
        s = mean_gt / max(float(np.mean(pseudo[:, 2])), 1e-6)
        out.append((pseudo * s).astype(np.float32))
    return np.stack(out)


def pool(cfg: dict, traffic: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The cell's ``traffic["pool"]`` distinct batches of
    ``traffic["batch"]`` pairs of ``traffic["scene"]``; with
    ``traffic["pseudo_stride"]``, each batch also holds ``target``, the
    pseudo clouds at that stride, and no image."""
    stride = traffic.get("pseudo_stride")
    out = []
    for i in range(traffic["pool"]):
        b = synthetic_batch(cfg, traffic["batch"], derived_seed(seed, 1, i),
                            traffic["scene"], dense_depth=stride is not None)
        if stride is not None:
            b["target"] = pseudo_clouds(b, stride)
            for k in ("depth", "img"):
                del b[k]
        out.append(b)
    return out
