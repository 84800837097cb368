"""Camera projection and coarse/fine label generation, counterpart of the
JAX package's ``ops/projection.py`` (reference
``models/multimodal_classifier.py:136-177``): project ``P @ pc`` through
``K``; a point is *inside* iff ``0 <= px <= W-1``, ``0 <= py <= H-1`` and
``z > 0.1``; the fine label is the index of the (H/32, W/32) grid cell
``floor(px/32) + floor(py/32) * W_fine``.

The products are written as elementwise sums in f32 (the JAX package pins
HIGHEST precision: a TF32 pass would move pixel coordinates and flip
boundary labels).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def project_points(pc: torch.Tensor, P: torch.Tensor, K: torch.Tensor):
    """pc (B, N, 3), P (B, 3|4, 4), K (B, 3, 3) ->
    (pxpy (B, N, 2), z (B, N)): pixel coordinates and camera depth."""
    pc, P, K = pc.float(), P.float(), K.float()
    cam = [pc[..., 0] * P[:, i, None, 0] + pc[..., 1] * P[:, i, None, 1]
           + pc[..., 2] * P[:, i, None, 2] + P[:, i, None, 3]
           for i in range(3)]
    hom = [cam[0] * K[:, i, None, 0] + cam[1] * K[:, i, None, 1]
           + cam[2] * K[:, i, None, 2] for i in range(3)]
    z = hom[2]
    return torch.stack([hom[0] / z, hom[1] / z], dim=-1), z


def coarse_labels(pxpy: torch.Tensor, z: torch.Tensor, H: int,
                  W: int) -> torch.Tensor:
    """Binary inside-frustum labels (B, N) int32
    (``multimodal_classifier.py:143-148``)."""
    x_in = (pxpy[..., 0] >= 0) & (pxpy[..., 0] <= W - 1)
    y_in = (pxpy[..., 1] >= 0) & (pxpy[..., 1] <= H - 1)
    return (x_in & y_in & (z > 0.1)).to(torch.int32)


def fine_labels(pxpy: torch.Tensor, scale: int, W_fine: int) -> torch.Tensor:
    """Fine grid-cell labels (B, N) int32, meaningful where inside
    (``multimodal_classifier.py:152-153``)."""
    cell = torch.floor(pxpy / scale).to(torch.int32)
    return cell[..., 0] + cell[..., 1] * W_fine


class Labels(NamedTuple):
    coarse: torch.Tensor           # (B, N) int32 in {0, 1}
    fine: torch.Tensor             # (B, N) int32, meaningful where coarse
    pxpy: torch.Tensor             # (B, N, 2) f32 pixel coordinates
    z: torch.Tensor                # (B, N) f32 camera-frame depth
    fine_violations: torch.Tensor  # () int32: insiders with a fine label
                                   # out of range


def generate_labels(pc, P, K, H: int, W: int, fine_scale: int) -> Labels:
    """Coarse and fine labels of one batch.  The reference asserts every
    insider's fine label is in range (``multimodal_classifier.py:169-172``);
    here the count of violations is returned and the labels are clipped
    into range, as in the JAX package."""
    pxpy, z = project_points(pc, P, K)
    coarse = coarse_labels(pxpy, z, H, W)
    W_fine = int(round(W / fine_scale))
    fine = fine_labels(pxpy, fine_scale, W_fine)
    L = W_fine * int(round(H / fine_scale))
    violations = torch.sum(coarse * ((fine < 0) | (fine >= L)).to(
        torch.int32)).to(torch.int32)
    fine = torch.clamp(fine, 0, L - 1)
    return Labels(coarse=coarse, fine=fine, pxpy=pxpy, z=z,
                  fine_violations=violations)
