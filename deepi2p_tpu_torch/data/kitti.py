"""KITTI odometry loader (numpy), the port's copy of the JAX package's
``data/kitti.py`` (``KittiLoader``, ``data/kitti_pc_img_pose_loader.py:91-446``
of the reference), over the preprocessed layout:

    <root>/data_odometry_velodyne_NWU/sequences/<SS>/voxel0.1-SNr0.6/<ffffff>.npy
        (7xN: xyz in NWU + intensity + surface normals)
    <root>/data_odometry_color_npy/sequences/<SS>/image_2|image_3/<ffffff>.npy
    <root>/poses/<SS>/<ffffff>.npz ('pose': 4x4)
    <root>/calib/<SS>/calib.txt

Sequences 0-8 train, 9-10 validate, both cameras, the first and last 40
frames skipped; +-``accumulation_frame_num`` frames at stride
``accumulation_frame_skip`` are accumulated into frame i; a random image
frame j within ``delta_ij_max`` and ``translation_max`` makes the pair;
the random pose, a 50% horizontal flip and the NWU -> camera fold give
``P = Pji @ Pc @ inv(P_cam_nwu) @ inv(Pr)``.  Every sample draws from the
loader's one generator in the JAX loader's order, so one seed and one
call order give the JAX loader's samples
(``tests/test_torch_port_data_loaders.py``).  No OpenCV: the images are
``.npy``.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

from ..config import Config
from . import base
from .augmentation import jitter, random_transform

P_CAM_NWU = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                      [1, 0, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
P_FLIP = np.diag(np.array([-1, 1, 1, 1], dtype=np.float32))


class KittiCalib:
    """calib.txt parser (``data/kitti_helper.py:25-64``): intrinsics
    ``Pi_K`` and camera/velodyne extrinsics ``Pi`` / ``Tr`` per sequence."""

    def __init__(self, root: str):
        self.mats: Dict[int, Dict[str, np.ndarray]] = {}
        calib_dir = os.path.join(root, "calib")
        for seq_name in sorted(os.listdir(calib_dir)):
            d: Dict[str, np.ndarray] = {}
            with open(os.path.join(calib_dir, seq_name, "calib.txt")) as f:
                for line in f:
                    key = line[:2]
                    mat = np.array(line[4:].split(),
                                   dtype=np.float64).reshape(3, 4)
                    if key == "Tr":
                        P = np.eye(4, dtype=np.float32)
                        P[:3] = mat
                        d["Tr"] = P
                    else:
                        K = mat[:3, :3].astype(np.float32)
                        d[key + "_K"] = K
                        tz = mat[2, 3]
                        tx = (mat[0, 3] - K[0, 2] * tz) / K[0, 0]
                        ty = (mat[1, 3] - K[1, 2] * tz) / K[1, 1]
                        P = np.eye(4, dtype=np.float32)
                        P[:3, 3] = [tx, ty, tz]
                        d[key] = P
            self.mats[int(seq_name)] = d

    def __call__(self, seq: int, key: str) -> np.ndarray:
        return self.mats[seq][key]


class KittiLoader:
    """Indexable KITTI samples; ``native=False`` samples the nodes with
    numpy instead of the native core."""

    NP_FOLDER = "voxel0.1-SNr0.6"
    SKIP = 40

    def __init__(self, root: str, mode: str, cfg: Config,
                 seed: int | None = None, native: bool = True):
        self.root, self.mode, self.cfg = root, mode, cfg
        self.native = native
        self.rng = np.random.default_rng(seed if seed is not None
                                         else cfg.seed)
        self.calib = KittiCalib(root)
        seqs = list(range(9)) if mode == "train" else [9, 10]
        self.index: List = []
        for seq in seqs:
            img2 = os.path.join(root, "data_odometry_color_npy", "sequences",
                                f"{seq:02d}", "image_2")
            if not os.path.isdir(img2):
                continue  # a partly downloaded dataset
            n = len(os.listdir(img2))
            for i in range(self.SKIP, n - self.SKIP):
                for cam in ("P2", "P3"):
                    self.index.append((seq, i, n, cam))

    def __len__(self):
        return len(self.index)

    # -- files ---------------------------------------------------------------
    def _pc_path(self, seq, i):
        return os.path.join(self.root, "data_odometry_velodyne_NWU",
                            "sequences", f"{seq:02d}", self.NP_FOLDER,
                            f"{i:06d}.npy")

    def _pose(self, seq, i):
        return np.load(os.path.join(self.root, "poses", f"{seq:02d}",
                                    f"{i:06d}.npz"))["pose"].astype(np.float32)

    def _img(self, seq, i, cam):
        folder = "image_2" if cam == "P2" else "image_3"
        return np.load(os.path.join(self.root, "data_odometry_color_npy",
                                    "sequences", f"{seq:02d}", folder,
                                    f"{i:06d}.npy"))

    # -- accumulation ----------------------------------------------------------
    def _accumulate(self, seq, i, n, Pc):
        raw = np.load(self._pc_path(seq, i)).astype(np.float32)
        raw = raw[:, self.rng.permutation(raw.shape[1])]
        pcs, ints, sns = [raw[:3]], [raw[3:4]], [raw[4:7]]
        if self.cfg.accumulation_frame_num > 0:
            P_oi = self._pose(seq, i)
            Pc_inv = np.linalg.inv(Pc)
            P_io = np.linalg.inv(P_oi)
            for stride in (-self.cfg.accumulation_frame_skip,
                           self.cfg.accumulation_frame_skip):
                for c in range(1, self.cfg.accumulation_frame_num + 1):
                    j = i + stride * c
                    if j < 0 or j >= n:
                        break
                    d = np.load(self._pc_path(seq, j)).astype(np.float32)
                    P_ij = P_io @ self._pose(seq, j)
                    T = Pc_inv @ P_ij @ Pc
                    pcs.append(T[:3, :3] @ d[:3] + T[:3, 3:4])
                    ints.append(d[3:4])
                    sns.append(T[:3, :3] @ d[4:7])
        return (np.concatenate(pcs, 1), np.concatenate(ints, 1),
                np.concatenate(sns, 1))

    def _pick_j(self, seq, i, n):
        cfg = self.cfg
        lo = max(i - cfg.delta_ij_max, 0)
        hi = min(i + cfg.delta_ij_max, n - 1)
        Pi = self._pose(seq, i)
        for _ in range(1000):
            j = int(self.rng.integers(lo, hi + 1))
            Pji = np.linalg.inv(self._pose(seq, j)) @ Pi
            if np.linalg.norm(Pji[:3, 3]) < cfg.translation_max:
                return j, Pji
        return i, np.eye(4, dtype=np.float32)

    # -------------------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg, rng = self.cfg, self.rng
        seq, i, n, cam = self.index[idx]
        Pc = self.calib(seq, cam) @ self.calib(seq, "Tr")

        pc_cn, int_cn, sn_cn = self._accumulate(seq, i, n, Pc)
        pc, (intensity, sn) = base.resample_points(
            pc_cn.T, [int_cn.T, sn_cn.T], cfg.input_pt_num, rng, voxel=0.3)

        if cfg.translation_max < 0:
            j, Pji = i, np.eye(4, dtype=np.float32)
        else:
            j, Pji = self._pick_j(seq, i, n)
        t_ji = Pji[:3, 3].copy()

        img = self._img(seq, j, cam)
        K = self.calib(seq, cam + "_K").copy()
        img, K = base.process_image(img, K, cfg,
                                    train=self.mode == "train", rng=rng)

        if self.mode == "train":
            Pr = random_transform(
                rng,
                (cfg.P_tx_amplitude, cfg.P_ty_amplitude, cfg.P_tz_amplitude),
                (cfg.P_Rx_amplitude, cfg.P_Ry_amplitude, cfg.P_Rz_amplitude))
            pc = jitter(pc, rng)
            sn = jitter(sn, rng)
            img = base.maybe_color_jitter(img, rng)
            if rng.random() > 0.5:
                img = np.ascontiguousarray(img[:, ::-1])
                Pr = Pr @ P_FLIP
        elif self.mode == "val_random_Ry":
            Pr = random_transform(rng, (0, 0, 0), (0, 2 * math.pi, 0))
        else:
            Pr = np.eye(4, dtype=np.float32)

        # NWU -> camera fold (kitti_pc_img_pose_loader.py:374-384)
        PrP = Pr @ P_CAM_NWU
        pc = pc @ PrP[:3, :3].T + PrP[:3, 3]
        sn = sn @ PrP[:3, :3].T
        P = Pji @ Pc @ np.linalg.inv(P_CAM_NWU) @ np.linalg.inv(Pr)

        return base.assemble_sample(cfg, rng, pc=pc, intensity=intensity,
                                    sn=sn, img=img, K=K, P=P, t_ij=t_ji,
                                    native=self.native)

    def __iter__(self):
        order = self.rng.permutation(len(self)) if self.mode == "train" \
            else np.arange(len(self))
        for i in order:
            yield self[int(i)]
