"""Auxiliary losses, counterpart of the JAX package's
``train/aux_losses.py`` (reference ``models/losses.py``; the reference's
classification training uses none of them).

Channel-last tensors: point clouds (B, N, D), heatmaps (B, H, W, 1).
Distances come from the port's :func:`~..ops.knn.pairwise_dist2`, which
differences coordinates directly where the JAX package expands
``|x|^2 + |y|^2 - 2 x.y``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.knn import pairwise_dist2


def gaussian_kernel_2d(kernel_size: int, sigma: float,
                       device=None) -> torch.Tensor:
    """Normalised separable gaussian (``models/losses.py:36-51``)."""
    x = torch.arange(kernel_size, dtype=torch.float32, device=device)
    mean = (kernel_size - 1) / 2.0
    g = torch.exp(-((x - mean) / sigma) ** 2 / 2.0)
    k = torch.outer(g, g)
    return k / k.sum()


def gaussian_smooth(img: torch.Tensor, kernel_size: int,
                    sigma: float) -> torch.Tensor:
    """Depthwise gaussian blur of (B, H, W, C) with reflect padding."""
    C = img.shape[-1]
    k = gaussian_kernel_2d(kernel_size, sigma, img.device).to(img.dtype)
    pad = kernel_size // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    y = F.conv2d(x, k.expand(C, 1, kernel_size, kernel_size), groups=C)
    return y.permute(0, 2, 3, 1)


def heatmap_loss(heatmap: torch.Tensor, keypoints_pxpy: torch.Tensor,
                 nms_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 between a predicted heatmap and the gaussian-splatted keypoint
    map (``models/losses.py:82-118``): heatmap (B, H, W, 1), keypoints
    (B, M, 2) -> (loss, target)."""
    B, H, W, _ = heatmap.shape
    idx = torch.round(keypoints_pxpy).to(torch.int64)
    flat = torch.clamp(idx[..., 1] * W + idx[..., 0], 0, H * W - 1)
    target = torch.zeros(B, H * W, dtype=heatmap.dtype,
                         device=heatmap.device)
    target = target.scatter(1, flat, 1.0).reshape(B, H, W, 1)
    target = gaussian_smooth(target, nms_size, nms_size / 6.0)
    return torch.mean(torch.abs(heatmap - target)), target


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(pairwise_dist2(a, b), min=1e-12))


def chamfer_loss(src: torch.Tensor, dst: torch.Tensor):
    """Symmetric chamfer over (B, M, D) / (B, N, D)
    (``models/losses.py:122-149``) -> (total, total, total)."""
    d = _dist(src, dst)
    total = d.amin(dim=2).mean() + d.amin(dim=1).mean()
    return total, total, total


def chamfer_loss_prob(src: torch.Tensor, dst: torch.Tensor,
                      sigma_src: Optional[torch.Tensor] = None,
                      sigma_dst: Optional[torch.Tensor] = None):
    """Uncertainty-weighted chamfer (``models/losses.py:152-202``):
    ``log(sigma) + dist / sigma`` with the nearest neighbour's sigma ->
    (loss, plain chamfer, weighted chamfer)."""
    if sigma_src is None or sigma_dst is None:
        return chamfer_loss(src, dst)
    d = _dist(src, dst)
    fwd_min, fwd_idx = d.min(dim=2)
    sig_fd = torch.gather(sigma_dst, 1, fwd_idx)
    forward = torch.mean(torch.log(sig_fd) + fwd_min / sig_fd)
    bwd_min, bwd_idx = d.min(dim=1)
    sig_bd = torch.gather(sigma_src, 1, bwd_idx)
    backward = torch.mean(torch.log(sig_bd) + bwd_min / sig_bd)
    with torch.no_grad():
        pure = fwd_min.mean() + bwd_min.mean()
        w_fd = (1.0 / sig_fd) / torch.mean(1.0 / sig_fd)
        w_bd = (1.0 / sig_bd) / torch.mean(1.0 / sig_bd)
        weighted = torch.mean(w_fd * fwd_min) + torch.mean(w_bd * bwd_min)
    return forward + backward, pure, weighted


def keypoint_on_pc_loss(keypoints: torch.Tensor,
                        pc: torch.Tensor) -> torch.Tensor:
    """Mean distance of each keypoint to its nearest cloud point
    (``models/losses.py:205-223``)."""
    return _dist(keypoints, pc).amin(dim=2).mean()


def img_keypoint_offset_norm_loss(offsets: torch.Tensor, box_dx: float,
                                  box_dy: float) -> torch.Tensor:
    """Penalise keypoint offsets (B, M, 2) outside the box
    (``models/losses.py:226-233``)."""
    a = torch.abs(offsets)
    mask = ((a[..., 0] > box_dx) | (a[..., 1] > box_dy)).to(offsets.dtype)
    return torch.mean(mask * torch.linalg.vector_norm(offsets, dim=-1))
