"""Depth map -> pseudo point cloud dump for the ICP pipeline, counterpart
of the JAX package's ``eval/depth.py`` (reference
``evaluation/icp/save_depth_map.py``): for each (prefix, image) item, a
depth estimator gives a depth map, :func:`~deepi2p_tpu_torch.register.icp.
depth_to_pointcloud` turns it into camera-frame points, and
``{prefix}_pc.npy`` (3, M) is written, the file the ICP stage of
:func:`~deepi2p_tpu_torch.eval.harness.evaluate_registration` reads.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..register.icp import depth_to_pointcloud


def dump_pseudo_pointclouds(items: Iterable, K: np.ndarray,
                            depth_fn: Callable[[np.ndarray], np.ndarray],
                            out_dir: str, *, stride: int = 4,
                            max_depth: float = 0.0, device="cuda") -> int:
    """Write ``{prefix}_pc.npy`` (3, M) for each (prefix, image) item.

    Args:
      items: iterable of (prefix, image (H, W, 3)) pairs.
      K: (3, 3) intrinsics of the images.
      depth_fn: any depth estimator, image -> (H, W) depth.
      stride: pixel stride of the pseudo cloud.
      max_depth: if > 0, drop points whose depth is >= this (scene-exit
        rays saturated at a far cap must not feed the ICP target).
      device: where the conversion runs (the card unless the caller names
        the CPU).
    Returns the number of clouds written.
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    Kt = torch.as_tensor(np.asarray(K, np.float32)).to(dev)
    n = 0
    for prefix, img in items:
        depth = torch.as_tensor(np.asarray(depth_fn(img), np.float32))
        pc = depth_to_pointcloud(depth.to(dev), Kt, stride=stride)
        pc = pc.cpu().numpy()
        if max_depth > 0:
            pc = pc[pc[:, 2] < max_depth]
        np.save(os.path.join(out_dir, f"{prefix}_pc.npy"),
                pc.T.astype(np.float32))
        n += 1
    return n
