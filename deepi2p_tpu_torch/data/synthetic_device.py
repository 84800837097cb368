"""Synthetic batches made on the device, counterpart of the JAX package's
``data/synthetic_jax.py``.

The scene family, surface mix, reflectance structure, pose amplitudes and
z-buffered render are those of the host generator (:mod:`.synthetic`), so
a run can switch generators: scenes are fresh every epoch, so only the
distribution must match, not the random stream.  Every draw comes from the
``torch.Generator`` the caller passes, on its device, batched over the
samples; on the card no batch crosses from the host.

The z-buffer is two scatters instead of the host's far-to-near splat: an
``amin`` race of the depth into a flat ``(H*W + 1)`` buffer per sample
(invalid points land in the pad slot), then ``amax`` payloads masked to the
winners of that race; the image is the host's up to exact depth ties.
The projection is written as explicit f32 sums of products, so that no
TF32 or matmul-precision setting moves a point across a pixel edge (the
labels are computed in exact f32, ``ops/projection.py``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..config import Config

_F32 = torch.float32


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=_F32)
    return u * (hi - lo) + lo


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=_F32)


def _euler_pose(gen: torch.Generator, cfg: Config, B: int) -> torch.Tensor:
    """(B, 3, 4) random poses with the dataset's perturbation amplitudes
    (``kitti/options.py:39-44``), R = Rz @ Ry @ Rx."""
    dev = gen.device
    amp = torch.tensor([cfg.P_Rx_amplitude, cfg.P_Ry_amplitude,
                        cfg.P_Rz_amplitude], dtype=_F32, device=dev)
    ang = _uniform(gen, (B, 3), -1.0, 1.0) * amp
    tamp = torch.tensor([cfg.P_tx_amplitude, cfg.P_ty_amplitude,
                         cfg.P_tz_amplitude], dtype=_F32, device=dev)
    t = _uniform(gen, (B, 3), -1.0, 1.0) * tamp
    cx, cy, cz = torch.cos(ang).unbind(-1)
    sx, sy, sz = torch.sin(ang).unbind(-1)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    R = _matmul3(Rz, _matmul3(Ry, Rx))
    return torch.cat([R, t[..., None]], dim=-1)


def _matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as f32 sums of products."""
    return torch.stack([torch.stack([
        A[..., i, 0] * B[..., 0, j] + A[..., i, 1] * B[..., 1, j]
        + A[..., i, 2] * B[..., 2, j] for j in range(3)], -1)
        for i in range(3)], -2)


def _street_cloud(gen: torch.Generator, B: int, n: int):
    """Ground plane, two segmented facades and box obstacles with true
    normals and per-surface reflectance (the host's ``_street_scene``),
    each sample with its own scene scalars.  Returns pc (B, n, 3),
    sn (B, n, 3), intensity (B, n, 1)."""
    dev = gen.device
    n_g = int(n * 0.4)
    n_f = int(n * 0.4)
    n_b = n - n_g - n_f

    # ground plane y = +2 (camera at y = 0), normal -y
    g = torch.stack([_uniform(gen, (B, n_g), -30.0, 30.0),
                     2.0 + 0.05 * _normal(gen, (B, n_g)),
                     _uniform(gen, (B, n_g), -40.0, 40.0)], dim=-1)
    g_n = torch.tensor([0.0, -1.0, 0.0], dtype=_F32,
                       device=dev).expand(B, n_g, 3)
    g_base = _uniform(gen, (B, 1), 0.05, 0.25)
    g_i = g_base + 0.04 * _normal(gen, (B, n_g))

    # two facades x = -wl / +wr, segmented into "buildings" along z
    wl = _uniform(gen, (B, 1), 8.0, 16.0)
    wr = _uniform(gen, (B, 1), 8.0, 16.0)
    left = _uniform(gen, (B, n_f), 0.0, 1.0) < 0.5
    x = torch.where(left, -wl, wr) + 0.05 * _normal(gen, (B, n_f))
    fz = _uniform(gen, (B, n_f), -40.0, 40.0)
    f = torch.stack([x, _uniform(gen, (B, n_f), -6.0, 2.0), fz], dim=-1)
    zf = torch.zeros_like(fz)
    f_n = torch.stack([torch.where(left, 1.0, -1.0).to(_F32), zf, zf], -1)
    seg_len = _uniform(gen, (B, 1), 8.0, 15.0)
    seg_phase = _uniform(gen, (B, 1), 0.0, 1.0) * seg_len
    seg = (torch.floor((fz + 40.0 + seg_phase) / seg_len).to(torch.int64)
           + 16 * left.to(torch.int64))
    seg_levels = _uniform(gen, (B, 48), 0.3, 1.0)
    f_i = (torch.gather(seg_levels, 1, torch.remainder(seg, 48))
           + 0.04 * _normal(gen, (B, n_f)))

    # box obstacles ("cars"): sample inside the unit box, push to the
    # nearest face, scale and translate per box
    nbox = 6
    centers = torch.stack([_uniform(gen, (B, nbox), -6.0, 6.0),
                           torch.ones(B, nbox, dtype=_F32, device=dev),
                           _uniform(gen, (B, nbox), -35.0, 35.0)], dim=-1)
    sizes = _uniform(gen, (B, nbox, 3), 1.5, 4.0)
    box_levels = _uniform(gen, (B, nbox), 0.3, 1.0)
    bi = torch.randint(0, nbox, (B, n_b), generator=gen, device=dev)
    local = _uniform(gen, (B, n_b, 3), -0.5, 0.5)
    face_ax = torch.argmax(torch.abs(local), dim=-1)
    onehot = torch.nn.functional.one_hot(face_ax, 3).to(_F32)
    sign = torch.sign(torch.gather(local, 2, face_ax[..., None]))
    local = local * (1.0 - onehot) + 0.5 * sign * onehot
    bi3 = bi[..., None].expand(B, n_b, 3)
    b = torch.gather(centers, 1, bi3) + local * torch.gather(sizes, 1, bi3)
    b_n = sign * onehot
    b_i = torch.gather(box_levels, 1, bi) + 0.04 * _normal(gen, (B, n_b))

    pc = torch.cat([g, f, b], dim=1)
    sn = torch.cat([g_n, f_n, b_n], dim=1)
    inten = torch.clamp(torch.cat([g_i, f_i, b_i], dim=1), 0.0, 1.0)
    # one random permutation per sample: the order of uniform keys
    perm = torch.argsort(_uniform(gen, (B, n), 0.0, 1.0), dim=1)
    perm3 = perm[..., None].expand(B, n, 3)
    return (torch.gather(pc, 1, perm3), torch.gather(sn, 1, perm3),
            torch.gather(inten, 1, perm)[..., None])


def _uniform_cloud(gen: torch.Generator, B: int, n: int):
    dev = gen.device
    lo = torch.tensor([-30.0, -5.0, -10.0], dtype=_F32, device=dev)
    hi = torch.tensor([30.0, 5.0, 40.0], dtype=_F32, device=dev)
    pc = lo + (hi - lo) * _uniform(gen, (B, n, 3), 0.0, 1.0)
    sn = _normal(gen, (B, n, 3))
    sn = sn / torch.linalg.vector_norm(sn, dim=-1, keepdim=True)
    inten = _uniform(gen, (B, n, 1), 0.0, 1.0)
    return pc, sn, inten


def _render(pc: torch.Tensor, intensity: torch.Tensor, P: torch.Tensor,
            K: torch.Tensor, H: int, W: int, gen: torch.Generator,
            with_depth: bool):
    """z-buffered splat, the nearest point wins each pixel.

    pc (B, n, 3), intensity (B, n, 1), P (B, 3, 4), K (B, 3, 3) ->
    (img (B, H, W, 3) f32, depth (B, H, W) f32 or None).  A pixel that a
    point reached holds ``(1275 / max(z, 1), 255 * intensity, 128)`` of
    its nearest point; the others uniform noise in [0, 60)."""
    B, n, _ = pc.shape
    dev = pc.device
    R, t = P[:, :3, :3], P[:, :3, 3]
    x, y, zz = pc[..., 0], pc[..., 1], pc[..., 2]
    cam = [x * R[:, k, 0:1] + y * R[:, k, 1:2] + zz * R[:, k, 2:3]
           + t[:, k:k + 1] for k in range(3)]
    z = cam[2]
    front = z > 0.1
    zs = torch.where(front, z, torch.ones_like(z))
    u = torch.floor(K[:, 0, 0:1] * cam[0] / zs + K[:, 0, 2:3]).to(torch.int64)
    v = torch.floor(K[:, 1, 1:2] * cam[1] / zs + K[:, 1, 2:3]).to(torch.int64)
    m = front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    HW = H * W
    # flat pixel index per sample; an invalid point lands in the pad slot
    # HW, which is sliced away
    base = torch.arange(B, device=dev)[:, None] * (HW + 1)
    p = torch.where(m, v * W + u, torch.full_like(u, HW)) + base
    p = p.reshape(-1)
    zbig = 1e9
    zimg = torch.full((B * (HW + 1),), zbig, dtype=_F32, device=dev)
    zimg = zimg.scatter_reduce(0, p, torch.where(
        m, z, torch.full_like(z, zbig)).reshape(-1), "amin")
    win = m.reshape(-1) & (z.reshape(-1) <= zimg[p] + 1e-6)
    winf = win.to(_F32)
    depth_c = torch.clamp(1275.0 / torch.clamp(z, min=1.0), 0.0, 255.0)
    zero = torch.zeros(B * (HW + 1), dtype=_F32, device=dev)
    ch0 = zero.scatter_reduce(0, p, depth_c.reshape(-1) * winf, "amax")
    ch1 = zero.scatter_reduce(0, p, intensity[..., 0].reshape(-1) * 255.0
                              * winf, "amax")

    def image(flat):
        return flat.reshape(B, HW + 1)[:, :HW].reshape(B, H, W)

    zmap = image(zimg)
    has_pt = zmap < zbig
    noise = _uniform(gen, (B, H, W, 3), 0.0, 60.0)
    splat = torch.stack([image(ch0), image(ch1),
                         torch.full((B, H, W), 128.0, dtype=_F32,
                                    device=dev)], dim=-1)
    img = torch.where(has_pt[..., None], splat, noise)
    if not with_depth:
        return img, None
    return img, torch.where(has_pt, zmap, torch.zeros_like(zmap))


@torch.no_grad()
def synthetic_batch_device(cfg: Config, generator: torch.Generator,
                           batch_size: int | None = None,
                           with_depth: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """A training batch made on ``generator.device``: the keys, shapes and
    dtypes of the host ``synthetic_batch`` (and of the JAX package's
    ``synthetic_batch_jax``), ``depth`` (B, H, W) added by
    ``with_depth``."""
    B = batch_size or cfg.batch_size
    N, Ma, Mb = cfg.input_pt_num, cfg.node_a_num, cfg.node_b_num
    H, W = cfg.img_H, cfg.img_W
    dev = generator.device
    street = getattr(cfg, "synthetic_scene", "uniform") == "street"
    # nuScenes: the configured ENU-z rotation is camera yaw before the
    # convention change below
    pose_cfg = cfg if cfg.dataset != "nuscenes" else cfg.replace(
        P_Ry_amplitude=cfg.P_Rz_amplitude, P_Rz_amplitude=0.0)

    pc, sn, inten = (_street_cloud(generator, B, N) if street
                     else _uniform_cloud(generator, B, N))
    P = _euler_pose(generator, pose_cfg, B)

    def nodes(M):
        idx = torch.randint(0, N, (B, M), generator=generator, device=dev)
        return torch.gather(pc, 1, idx[..., None].expand(B, M, 3))

    node_a, node_b = nodes(Ma), nodes(Mb)
    f = 0.6 * W
    K = torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]],
                     dtype=_F32, device=dev).expand(B, 3, 3).contiguous()
    # img_render_n: splat the first rn (permuted, so uniform) points, so
    # the image density does not depend on input_pt_num
    rn = getattr(cfg, "img_render_n", 0) or N
    img, depth = _render(pc[:, :rn], inten[:, :rn], P, K, H, W, generator,
                         with_depth)
    out = dict(pc=pc, intensity=inten, sn=sn, node_a=node_a, node_b=node_b,
               P=P, img=img, K=K)
    if with_depth:
        out["depth"] = depth
    if cfg.dataset == "nuscenes":
        # ENU convention change, as the host generator makes it
        # (pc @ C3 and P4 @ C), written as the exact column moves of C:
        # (x, y, z) -> (x, z, -y); the projected geometry is unchanged
        for k in ("pc", "sn", "node_a", "node_b"):
            a = out[k]
            out[k] = torch.stack([a[..., 0], a[..., 2], -a[..., 1]], -1)
        out["P"] = torch.stack([P[..., 0], P[..., 2], -P[..., 1], P[..., 3]],
                               dim=-1)
    return {k: v.contiguous() for k, v in out.items()}


@torch.no_grad()
def synthetic_stacked_device(cfg: Config,
                             generators: Sequence[torch.Generator],
                             batch_size: int | None = None
                             ) -> Dict[str, torch.Tensor]:
    """(K, B, ...) stacked batches for a K-step call
    (``Engine.train_step_scan``; the JAX package's
    ``synthetic_stacked_jax``): batch k is :func:`synthetic_batch_device`
    of ``generators[k]``, so a stack of K per-step generators holds the
    batches K single steps would take."""
    batches = [synthetic_batch_device(cfg, g, batch_size)
               for g in generators]
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
