"""nuScenes helpers of the port.  Only the ENU -> camera conversion the
evaluation harness needs; the loader comes with the data slice."""
from __future__ import annotations

import numpy as np


def enu2cam(pc: np.ndarray, P: np.ndarray):
    """ENU point cloud + pose -> camera-convention pair
    (``evaluation/registration_lsq.py:237-248``)."""
    C = np.array([[1, 0, 0, 0], [0, 0, -1, 0],
                  [0, 1, 0, 0], [0, 0, 0, 1]], dtype=P.dtype)
    return pc @ C[:3, :3].T, P @ np.linalg.inv(C)
