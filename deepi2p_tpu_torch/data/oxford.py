"""Oxford RobotCar loader (numpy), the port's copy of the JAX package's
``data/oxford.py`` (``OxfordLoader``,
``data/oxford_pc_img_pose_loader.py:100-380`` of the reference), over the
layout of the offline builder (``data/oxford/build_dataset.py:319-390``):

    <root>/train.txt, val.txt
    <root>/<traversal>/pc_timestamps.npy, pc_poses.npy (Nx4x4),
                       camera_timestamps.npy, camera_poses.npy,
                       lms_front/<ts>.npy (4xN: xyz + reflectance),
                       stereo/centre/<ts>.jpg

Poses move to the camera convention by ``P_convert`` (``:70-78``); the
intrinsics are the reference's constants (``:221``); the camera frame is
drawn among the frames within ``ceil(translation_max /
pc_build_interval)`` clouds until ``|t| < translation_max``
(``:181-214``); the range limit is ``sqrt(x^2 + z^2) < pc_max_range``;
clouds over 2N are voxel-downsampled at 0.2 m first; Oxford has no
normals.  The JPEG is decoded by the port's own decoder
(:func:`~.base.load_image`, bitwise ``cv2.imread``), at half size in the
DCT domain at the Oxford preset.  Every sample draws from the loader's
one generator in the JAX loader's order.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

from ..config import Config
from . import base
from .augmentation import random_transform, jitter

OXFORD_K = np.array([[964.828979, 0.0, 643.788025],
                     [0.0, 964.828979, 484.407990],
                     [0.0, 0.0, 1.0]], dtype=np.float32)

_P_CONVERT = np.array([[0, 1, 0, 0], [0, 0, 1, 0],
                       [1, 0, 0, 0], [0, 0, 0, 1]], dtype=np.float32)


def _read_split(path: str) -> List[str]:
    with open(path) as f:
        return [x.strip() for x in f if x.strip()]


class OxfordLoader:
    """Indexable Oxford samples; ``native=False`` samples the nodes with
    numpy instead of the native core."""

    def __init__(self, root: str, mode: str, cfg: Config,
                 seed: int | None = None, native: bool = True):
        self.root, self.mode, self.cfg = root, mode, cfg
        self.native = native
        self.rng = np.random.default_rng(seed if seed is not None else cfg.seed)

        split = "train.txt" if mode == "train" else "val.txt"
        self.traversals = _read_split(os.path.join(root, split))
        self.index: List = []          # (traversal, pc_ts, pc_idx)
        self.pc_ts: Dict[str, np.ndarray] = {}
        self.pc_poses: Dict[str, np.ndarray] = {}
        self.cam_ts: Dict[str, np.ndarray] = {}
        self.cam_poses: Dict[str, np.ndarray] = {}
        inv = np.linalg.inv(_P_CONVERT)
        for trav in self.traversals:
            tdir = os.path.join(root, trav)
            pts = np.load(os.path.join(tdir, "pc_timestamps.npy"))
            ppo = np.load(os.path.join(tdir, "pc_poses.npy")).astype(np.float32)
            cts = np.load(os.path.join(tdir, "camera_timestamps.npy"))
            cpo = np.load(os.path.join(tdir, "camera_poses.npy")).astype(np.float32)
            self.pc_ts[trav] = pts
            self.pc_poses[trav] = _P_CONVERT @ ppo @ inv
            self.cam_ts[trav] = cts
            self.cam_poses[trav] = _P_CONVERT @ cpo @ inv
            for i, ts in enumerate(pts):
                self.index.append((trav, int(ts), i))

    def __len__(self):
        return len(self.index)

    # ------------------------------------------------------------------
    def _pick_camera(self, trav: str, pc_idx: int):
        cfg = self.cfg
        tmax = (cfg.translation_max if self.mode == "train"
                else cfg.test_translation_max)
        interval = math.ceil(tmax / cfg.pc_build_interval)
        pts = self.pc_ts[trav]
        lo_ts = pts[max(0, pc_idx - interval)]
        hi_ts = pts[min(len(pts) - 1, pc_idx + interval)]
        cts = self.cam_ts[trav]
        lo = int(np.searchsorted(cts, lo_ts, side="left"))
        hi = int(np.searchsorted(cts, hi_ts, side="left"))
        hi = min(hi, len(cts) - 1)
        P_o_pc = self.pc_poses[trav][pc_idx]
        for _ in range(1000):
            ci = int(self.rng.integers(lo, hi + 1))
            P_cam_pc = np.linalg.inv(self.cam_poses[trav][ci]) @ P_o_pc
            if np.linalg.norm(P_cam_pc[:3, 3]) < tmax:
                return ci, P_cam_pc
        return ci, P_cam_pc  # degenerate traversal; accept last

    # ------------------------------------------------------------------
    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        cfg, rng = self.cfg, self.rng
        trav, pc_ts, pc_idx = self.index[i]
        cam_idx, P_cam_pc = self._pick_camera(trav, pc_idx)

        # image --------------------------------------------------------
        cam_ts = int(self.cam_ts[trav][cam_idx])
        img_path = os.path.join(self.root, trav, "stereo", "centre",
                                f"{cam_ts}.jpg")
        img, pre_scaled = base.load_image(img_path, cfg)
        img, K = base.process_image(img, OXFORD_K.copy(), cfg,
                                    train=self.mode == "train", rng=rng,
                                    pre_scaled=pre_scaled)

        # points (already in camera coords on disk) ---------------------
        lidar = ("lms_front_foreground" if cfg.is_remove_ground
                 else "lms_front")
        raw = np.load(os.path.join(self.root, trav, lidar,
                                   f"{pc_ts}.npy")).astype(np.float32)
        raw = raw[:, self.rng.permutation(raw.shape[1])]
        pc = raw[:3].T                           # (N0, 3)
        intensity = raw[3:4].T                   # (N0, 1)
        if cfg.pc_max_range > 0:
            keep = pc[:, 0] ** 2 + pc[:, 2] ** 2 < cfg.pc_max_range ** 2
            pc, intensity = pc[keep], intensity[keep]
        pc, (intensity,) = base.resample_points(pc, [intensity],
                                                cfg.input_pt_num, rng,
                                                voxel=0.2)

        # pose perturbation & augmentation ------------------------------
        if self.mode == "train":
            Pr = random_transform(
                rng,
                (cfg.P_tx_amplitude, cfg.P_ty_amplitude, cfg.P_tz_amplitude),
                (cfg.P_Rx_amplitude, cfg.P_Ry_amplitude, cfg.P_Rz_amplitude))
            pc = jitter(pc, rng)
            intensity = jitter(intensity, rng)
            if rng.random() > 0.5:
                img = base.maybe_color_jitter(img, rng)
        elif self.mode == "val_random_Ry":
            Pr = random_transform(rng, (0, 0, 0), (0, 2 * math.pi, 0))
        else:
            Pr = np.eye(4, dtype=np.float32)

        t_ij = P_cam_pc[:3, 3].copy()
        P = P_cam_pc @ np.linalg.inv(Pr)
        pc = pc @ Pr[:3, :3].T + Pr[:3, 3]

        sn = np.zeros_like(pc)                   # oxford has no normals
        return base.assemble_sample(cfg, rng, pc=pc, intensity=intensity,
                                    sn=sn, img=img, K=K, P=P, t_ij=t_ij,
                                    native=self.native)

    def __iter__(self):
        order = self.rng.permutation(len(self)) if self.mode == "train" \
            else np.arange(len(self))
        for i in order:
            yield self[int(i)]
