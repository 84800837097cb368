"""Point sampling: farthest-point sampling, voxel-grid downsampling and
random resampling for the data path (numpy, host-side), and
:func:`farthest_point_sample` on a device (torch).

The numpy functions are the port's copy of the numpy half of the JAX
package's ``ops/sampling.py``; each function draws from its generator exactly as
the JAX one does, so one seed gives one result in both packages
(``tests/test_torch_port_data_sampling.py``).  The voxel average sums
each column with ``np.bincount`` in float64 and in input order, the same
sums ``np.add.at`` forms there, at about a third of the time.
"""
from __future__ import annotations

import numpy as np
import torch


def farthest_point_sample_np(pts: np.ndarray, k: int,
                             rng: np.random.Generator | None = None):
    """FPS over (N, D) points -> (samples (k, D), indices (k,)): a random
    first point, then the farthest from those chosen, k - 1 times
    (``data/kitti_helper.py:224-243``)."""
    rng = rng or np.random.default_rng()
    n = pts.shape[0]
    idx = np.zeros(k, dtype=np.int64)
    idx[0] = rng.integers(n)
    d = np.sum((pts - pts[idx[0]]) ** 2, axis=1)
    for i in range(1, k):
        idx[i] = int(np.argmax(d))
        d = np.minimum(d, np.sum((pts - pts[idx[i]]) ** 2, axis=1))
    return pts[idx], idx


def farthest_point_sample(pts: torch.Tensor, k: int,
                          generator: torch.Generator | None = None, *,
                          first=None) -> torch.Tensor:
    """FPS on the device of ``pts`` (..., N, D) -> indices (..., k) int32,
    the JAX package's ``farthest_point_sample``: a first index, then k - 1
    times the point farthest from those chosen (ties to the lowest
    index).  The first index is ``first`` (an int or a (...,) tensor) or
    a draw from ``generator`` (on its device); one of them is needed.
    Squared distances sum the coordinates in order."""
    *lead, n, D = pts.shape
    p = pts.reshape(-1, n, D)
    B = p.shape[0]
    if first is None:
        if generator is None:
            raise ValueError("farthest_point_sample needs a generator or "
                             "first=")
        first = torch.randint(0, n, (B,), generator=generator,
                              device=generator.device)
    cur = torch.as_tensor(first, device=p.device).to(torch.int64)
    cur = cur.reshape(-1).expand(B).clone()
    rows = torch.arange(B, device=p.device)

    def dist_to(i):
        c = p[rows, i]                                        # (B, D)
        d = None
        for j in range(D):
            diff = p[..., j] - c[:, j:j + 1]
            d = diff * diff if d is None else d + diff * diff
        return d

    idx = torch.zeros(B, k, dtype=torch.int64, device=p.device)
    idx[:, 0] = cur
    dist = dist_to(cur)
    for i in range(1, k):
        cur = torch.argmax(dist, dim=1)
        idx[:, i] = cur
        dist = torch.minimum(dist, dist_to(cur))
    return idx.reshape(*lead, k).to(torch.int32)


def _voxel_mean(inv: np.ndarray, counts: np.ndarray,
                cols: np.ndarray) -> np.ndarray:
    """Per-voxel float64 mean of each column of ``cols`` (N, C)."""
    out = np.empty((len(counts), cols.shape[1]), np.float64)
    for c in range(cols.shape[1]):
        out[:, c] = np.bincount(inv, weights=cols[:, c].astype(np.float64),
                                minlength=len(counts))
    out /= counts[:, None]
    return out


def voxel_downsample_np(pc: np.ndarray, voxel_size: float,
                        extra: np.ndarray | None = None):
    """Voxel-grid average of (N, 3) points, as open3d's
    ``voxel_down_sample``; ``extra`` (N, E) (intensity, normals) is
    averaged per voxel alongside (``data/kitti_pc_img_pose_loader.py:26-44``).
    Voxels come in the order of their sorted keys."""
    coords = np.floor(pc / voxel_size).astype(np.int64)
    coords -= coords.min(axis=0)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    out = _voxel_mean(inv, counts, pc)
    if extra is None:
        return out.astype(pc.dtype)
    return (out.astype(pc.dtype),
            _voxel_mean(inv, counts, extra).astype(extra.dtype))


def random_resample_np(n_have: int, n_want: int,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Indices of exactly ``n_want`` points: a draw without replacement
    when there are enough, else all points plus random duplicates
    (``data/kitti_pc_img_pose_loader.py:158-171``)."""
    rng = rng or np.random.default_rng()
    if n_have >= n_want:
        return rng.choice(n_have, n_want, replace=False)
    dup = rng.choice(n_have, n_want - n_have, replace=True)
    return np.concatenate([np.arange(n_have), dup])


def projective_farthest_sample_np(pts: np.ndarray, k: int, K: np.ndarray,
                                  rng: np.random.Generator | None = None):
    """FPS in the image plane (project with ``K``, FPS over the pixels),
    returning the 3-D points (``data/kitti_helper.py:206-221``)."""
    rng = rng or np.random.default_rng()
    proj = pts @ K.T
    uv = proj[:, :2] / proj[:, 2:3]
    _, idx = farthest_point_sample_np(uv, k, rng)
    return pts[idx], idx


def fps_approximate_np(pc: np.ndarray, voxel_size: float, node_num: int,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Approximate FPS: voxel-downsample, shrinking the voxel by 0.75
    until ``node_num`` points remain, then pick ``node_num`` at random
    (``data/kitti_helper.py:253-258``)."""
    rng = rng or np.random.default_rng()
    down = voxel_downsample_np(pc, voxel_size)
    while down.shape[0] < node_num:
        voxel_size *= 0.75
        down = voxel_downsample_np(pc, voxel_size)
    return down[rng.choice(down.shape[0], node_num, replace=False)]
