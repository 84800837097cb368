"""nuScenes loader (numpy), the port's copy of the JAX package's
``data/nuscenes.py`` (``nuScenesLoader``,
``data/nuscenes_pc_img_pose_loader.py:100-408`` of the reference).

Record access sits behind the ``NuScenesBackend`` protocol, with two
implementations: the nuscenes-devkit where it imports
(``devkit_backend``) and the port's table reader (``tables_backend`` over
:mod:`~.nuscenes_tables`).  Ego-car returns are dropped by the |x|<0.8,
|y|<2.7 box; accumulation walks the sample_data chain keeping every
``accumulation_frame_skip``-th frame until ``accumulation_frame_num`` per
direction; a random camera of 6 and a random nearby token of it make the
pair (``dataset_info.list``, ``data/nuscenes/make_datasets.py:79-155``);
the cloud stays in the LiDAR (ENU-like) frame and the random pose rotates
about z; ``enu2cam`` converts a pair to the camera convention for
evaluation (``evaluation/registration_lsq.py:237-248``).  Camera images
are JPEGs, decoded by the port's own decoder (:func:`~.base.read_rgb`,
bitwise ``cv2.imread``).  Every sample
draws from the loader's one generator in the JAX loader's order.
"""
from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Protocol, Tuple

import numpy as np

from ..config import Config
from . import base
from .augmentation import random_transform, jitter

CAMERA_NAMES = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]


def remove_ego_points(pc: np.ndarray, intensity: np.ndarray):
    """Drop returns on the ego vehicle (|x|<0.8 and |y|<2.7), (N,3)/(N,1)."""
    inside = (np.abs(pc[:, 0]) < 0.8) & (np.abs(pc[:, 1]) < 2.7)
    return pc[~inside], intensity[~inside]


class NuScenesBackend(Protocol):
    """Minimal slice of the nuscenes-devkit API used by the loader."""

    def lidar_points(self, token: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (pc (N,3), intensity (N,1)) in the sensor frame."""
    def ego_pose(self, token: str) -> np.ndarray: ...
    def calibration(self, token: str) -> np.ndarray: ...
    def camera_K(self, token: str) -> np.ndarray: ...
    def camera_image(self, token: str) -> np.ndarray: ...
    def neighbor(self, token: str, direction: str) -> str:
        """next/prev sample_data token, '' at chain end."""


def load_dataset_info(root: str) -> List:
    """The pickled (lidar_token, {camera: [nearby tokens]}) list that the
    offline pairing script writes (``data/nuscenes/make_datasets.py:190-196``);
    a file of the dataset's own preparation, unpickled as such."""
    with open(os.path.join(root, "dataset_info.list"), "rb") as f:
        return pickle.load(f)


def _record_backend(nusc, P_from, read_lidar) -> "NuScenesBackend":
    """NuScenesBackend over any NuScenes-shaped record store (the real
    devkit or the in-repo :class:`~.nuscenes_tables.NuScenesTables`)."""

    class _Backend:
        def lidar_points(self, token):
            sd = nusc.get("sample_data", token)
            return read_lidar(os.path.join(nusc.dataroot, sd["filename"]))

        def ego_pose(self, token):
            sd = nusc.get("sample_data", token)
            return P_from(nusc.get("ego_pose", sd["ego_pose_token"]))

        def calibration(self, token):
            sd = nusc.get("sample_data", token)
            return P_from(nusc.get("calibrated_sensor",
                                   sd["calibrated_sensor_token"]))

        def camera_K(self, token):
            sd = nusc.get("sample_data", token)
            calib = nusc.get("calibrated_sensor",
                             sd["calibrated_sensor_token"])
            return np.asarray(calib["camera_intrinsic"], np.float32)

        def camera_image(self, token):
            sd = nusc.get("sample_data", token)
            return base.read_rgb(os.path.join(nusc.dataroot, sd["filename"]))

        def neighbor(self, token, direction):
            return nusc.get("sample_data", token)[direction]

    return _Backend()


def devkit_backend(root: str, version: str) -> "NuScenesBackend":
    """Backend over the nuscenes-devkit (optional dependency)."""
    from nuscenes.nuscenes import NuScenes          # type: ignore
    from nuscenes.utils.data_classes import LidarPointCloud  # type: ignore
    from pyquaternion import Quaternion             # type: ignore

    nusc = NuScenes(version=version, dataroot=root, verbose=False)

    def P_from(rec):
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = Quaternion(rec["rotation"]).rotation_matrix
        P[:3, 3] = rec["translation"]
        return P

    def read_lidar(path):
        pc = LidarPointCloud.from_file(path)
        return pc.points[:3].T.astype(np.float32), \
            pc.points[3:4].T.astype(np.float32)

    return _record_backend(nusc, P_from, read_lidar)


def tables_backend(root: str, version: str) -> "NuScenesBackend":
    """Backend over the port's table reader (:mod:`~.nuscenes_tables`),
    no devkit needed."""
    from .nuscenes_tables import NuScenesTables, pose_matrix, read_lidar_bin
    nusc = NuScenesTables(version=version, dataroot=root)
    return _record_backend(nusc, pose_matrix, read_lidar_bin)


def default_backend(root: str, version: str) -> "NuScenesBackend":
    """Prefer the devkit when installed (exact upstream file handling),
    else the in-repo table reader."""
    try:
        import nuscenes  # type: ignore  # noqa: F401
    except ImportError:
        return tables_backend(root, version)
    return devkit_backend(root, version)


class NuScenesLoader:
    """Indexable nuScenes samples; ``native=False`` samples the nodes with
    numpy instead of the native core."""

    def __init__(self, root: str, mode: str, cfg: Config,
                 backend: NuScenesBackend | None = None,
                 dataset: List | None = None, seed: int | None = None,
                 native: bool = True):
        self.mode, self.cfg = mode, cfg
        self.native = native
        self.rng = np.random.default_rng(seed if seed is not None else cfg.seed)
        sub = os.path.join(root, "trainval" if mode == "train" else "test")
        self.dataset = dataset if dataset is not None else load_dataset_info(sub)
        if backend is None:
            version = "v1.0-trainval" if mode == "train" else "v1.0-test"
            backend = default_backend(sub, version)
        self.backend = backend

    def __len__(self):
        return len(self.dataset)

    # ------------------------------------------------------------------
    def _accumulate(self, lidar_token: str):
        bk, cfg = self.backend, self.cfg
        pc_i, int_i = bk.lidar_points(lidar_token)
        pc_i, int_i = remove_ego_points(pc_i, int_i)
        pcs, ints = [pc_i], [int_i]
        P_io = np.linalg.inv(bk.ego_pose(lidar_token))
        P_vl = bk.calibration(lidar_token)
        P_lv = np.linalg.inv(P_vl)
        for direction in ("next", "prev"):
            tok, counter, taken = lidar_token, 1, 0
            while taken < cfg.accumulation_frame_num:
                tok = self.backend.neighbor(tok, direction)
                if not tok:
                    break
                if counter % cfg.accumulation_frame_skip != 0:
                    counter += 1
                    continue
                pc_j, int_j = bk.lidar_points(tok)
                pc_j, int_j = remove_ego_points(pc_j, int_j)
                P_ij = P_io @ bk.ego_pose(tok)
                T = P_lv @ P_ij @ P_vl
                pcs.append(pc_j @ T[:3, :3].T + T[:3, 3])
                ints.append(int_j)
                counter += 1
                taken += 1
        return np.concatenate(pcs), np.concatenate(ints)

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg, rng, bk = self.cfg, self.rng, self.backend
        lidar_token, nearby = self.dataset[idx]

        pc, intensity = self._accumulate(lidar_token)
        pc, (intensity,) = base.resample_points(pc, [intensity],
                                                cfg.input_pt_num, rng,
                                                voxel=0.2)

        cam_name = CAMERA_NAMES[rng.integers(len(CAMERA_NAMES))]
        tokens = nearby[cam_name]
        cam_token = tokens[rng.integers(len(tokens))]
        img = bk.camera_image(cam_token)
        K = bk.camera_K(cam_token).copy()
        img, K = base.process_image(img, K, cfg,
                                    train=self.mode == "train", rng=rng)

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
            Pr = random_transform(rng, (0, 0, 0), (0, 0, 2 * math.pi))
        else:
            Pr = np.eye(4, dtype=np.float32)

        pc = pc @ Pr[:3, :3].T + Pr[:3, 3]

        P_cam_pc = (np.linalg.inv(bk.calibration(cam_token))
                    @ np.linalg.inv(bk.ego_pose(cam_token))
                    @ bk.ego_pose(lidar_token)
                    @ bk.calibration(lidar_token))
        P = P_cam_pc @ np.linalg.inv(Pr)
        t_ij = P_cam_pc[:3, 3].copy()

        sn = np.zeros_like(pc)
        return base.assemble_sample(cfg, rng, pc=pc, intensity=intensity,
                                    sn=sn, img=img, K=K, P=P, t_ij=t_ij,
                                    native=self.native)

    def __iter__(self):
        order = self.rng.permutation(len(self)) if self.mode == "train" \
            else np.arange(len(self))
        for i in order:
            yield self[int(i)]


def enu2cam(pc: np.ndarray, P: np.ndarray):
    """ENU point cloud + pose -> camera-convention pair
    (``evaluation/registration_lsq.py:237-248``)."""
    C = np.array([[1, 0, 0, 0], [0, 0, -1, 0],
                  [0, 1, 0, 0], [0, 0, 0, 1]], dtype=P.dtype)
    return pc @ C[:3, :3].T, P @ np.linalg.inv(C)
