"""Registration error metrics, counterpart of the JAX package's
``register/metrics.py`` (reference ``evaluation/registration_pnp.py:84-92``,
``evaluation/registration_result_analysis.py:37-47``):

* ``P_diff = inv(P_pred) @ P_gt``;
* RTE = ||translation(P_diff)||_2;
* RRE = sum |euler('xzy', degrees)| of rotation(P_diff), extrinsic x-z-y;
* success: RTE < 2 m and RRE < 5 deg.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _euler_xzy(R: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-z-y euler angles (radians) of R (..., 3, 3):
    ``R = Ry(g) Rz(b) Rx(a)``."""
    b = torch.asin(torch.clamp(R[..., 1, 0], -1.0, 1.0))
    a = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    g = torch.atan2(-R[..., 2, 0], R[..., 0, 0])
    return torch.stack([a, b, g], dim=-1)


def pose_diff(P_pred: torch.Tensor, P_gt: torch.Tensor):
    """(RTE, RRE in degrees) for (..., 4, 4) pose pairs."""
    D = torch.linalg.solve(P_pred, P_gt)
    rte = torch.linalg.norm(D[..., :3, 3], dim=-1)
    rre = torch.sum(torch.abs(_euler_xzy(D[..., :3, :3])), dim=-1)
    return rte, rre * (180.0 / math.pi)


def pose_diff_np(P_pred: np.ndarray, P_gt: np.ndarray):
    """(RTE, RRE in degrees) of one pose pair on the host, through scipy
    (the JAX package's ``pose_diff_np``; the harness's metric)."""
    from scipy.spatial.transform import Rotation
    D = np.linalg.inv(P_pred) @ P_gt
    rte = float(np.linalg.norm(D[:3, 3]))
    rre = float(np.sum(np.abs(
        Rotation.from_matrix(D[:3, :3]).as_euler("xzy", degrees=True))))
    return rte, rre


def registration_summary(rte, rre, rte_thresh: float = 2.0,
                         rre_thresh: float = 5.0) -> Dict[str, float]:
    """Mean/std errors and success rate
    (``evaluation/registration_result_analysis.py:37-47``)."""
    rte = np.asarray(rte, np.float64)
    rre = np.asarray(rre, np.float64)
    ok = (rte < rte_thresh) & (rre < rre_thresh)
    return {
        "rte_mean": float(rte.mean()), "rte_std": float(rte.std()),
        "rre_mean": float(rre.mean()), "rre_std": float(rre.std()),
        "success_rate": float(ok.mean()),
        "rte_mean_success": float(rte[ok].mean()) if ok.any() else float("nan"),
        "rre_mean_success": float(rre[ok].mean()) if ok.any() else float("nan"),
        "num_pairs": int(rte.size),
    }
