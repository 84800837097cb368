"""KITTI offline preparation, counterpart of the JAX package's
``data/prep/kitti_prep.py``.

Replaces ``data/kitti/kitti_pc_bin_to_npy_with_downsample_sn.py`` (bin ->
voxel-0.1 downsample + surface normals), ``data/kitti_png_to_npy.py`` and
the pose split, open3d- and OpenCV-free:

  * velodyne ``.bin`` -> camera-independent NWU cloud with intensity;
  * voxel-grid downsample;
  * surface normals by local PCA over kNN neighbourhoods, oriented to +z
    like the reference (``kitti_pc_bin_to_npy_with_downsample_sn.py:58-61``);
  * per-frame ``.npy`` of shape (7, N): xyz + intensity + normals;
  * image ``.png`` -> ``.npy`` uint8 RGB arrays
    (:func:`~..jpeg.read_png`: 8-bit non-interlaced PNGs);
  * ``poses/XX.txt`` (odometry ground truth) -> per-frame ``.npz``
    with a 4x4 'pose' entry, the layout the loader consumes.

The kNN and the voxel average run in the port's native core
(:mod:`..native`, built at first use; a failed build raises).
``native=False`` takes the numpy route instead, the JAX package's
fallback where its own library is not built: the voxel average of
:func:`~...ops.sampling.voxel_downsample_np` (voxels in sorted-key order,
where the core keeps its hash order) and a brute-force kNN.
"""
from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from ...ops.sampling import voxel_downsample_np
from .. import native as native_core
from ..base import crop_pc_with_img
from ..jpeg import read_png


def _knn(query: np.ndarray, database: np.ndarray, k: int,
         native: bool) -> np.ndarray:
    if native:
        return native_core.knn(query, database, k)
    query = np.ascontiguousarray(query, np.float32)
    database = np.ascontiguousarray(database, np.float32)
    d = np.sum((query[:, None] - database[None]) ** 2, axis=-1)
    return np.argsort(d, axis=1)[:, :k].astype(np.int64)


def _voxel(pts: np.ndarray, voxel: float, extras: np.ndarray,
           native: bool):
    if native:
        return native_core.voxel_downsample(pts, voxel, extras)
    return voxel_downsample_np(np.ascontiguousarray(pts, np.float32),
                               voxel, extras)


def estimate_normals(pc: np.ndarray, k: int = 16,
                     orient_positive_z: bool = True, *,
                     native: bool = True) -> np.ndarray:
    """PCA normals over kNN neighbourhoods; (N, 3) -> (N, 3) unit normals."""
    idx = _knn(pc, pc, k, native)               # (N, k)
    nb = pc[idx]                                # (N, k, 3)
    centered = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    # smallest eigenvector of each 3x3 covariance
    _, v = np.linalg.eigh(cov)
    normals = v[:, :, 0]
    if orient_positive_z:
        flip = normals[:, 2] < 0
        normals[flip] = -normals[flip]
    n = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(n, 1e-12)).astype(np.float32)


def _save_cloud(out_path: str, pc_d: np.ndarray, inten_d: np.ndarray,
                normal_k: int, native: bool) -> int:
    sn = estimate_normals(pc_d, k=normal_k, native=native)
    out = np.concatenate([pc_d.T, inten_d.T, sn.T], axis=0).astype(np.float32)
    np.save(out_path, out)
    return out.shape[1]


def prepare_frame(bin_path: str, out_path: str, *, voxel: float = 0.1,
                  normal_k: int = 16, native: bool = True) -> int:
    """One velodyne ``.bin`` -> (7, N) ``.npy``; returns N.  The velodyne
    frame is already x-forward / y-left / z-up, the NWU frame."""
    raw = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
    pc_d, inten_d = _voxel(raw[:, :3], voxel, raw[:, 3:4], native)
    return _save_cloud(out_path, pc_d, inten_d, normal_k, native)


def prepare_kitti_velodyne(root: str, out_root: str, sequences=None, *,
                           voxel: float = 0.1, workers: int = 8,
                           folder_name: str = "voxel0.1-SNr0.6",
                           native: bool = True) -> int:
    """Convert all ``velodyne/*.bin`` of the odometry sequences; returns
    the number of frames written (existing outputs are kept)."""
    sequences = sequences if sequences is not None else list(range(11))
    jobs = []
    for seq in sequences:
        src = os.path.join(root, "sequences", f"{seq:02d}", "velodyne")
        dst = os.path.join(out_root, "sequences", f"{seq:02d}", folder_name)
        if not os.path.isdir(src):
            continue
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(src)):
            if f.endswith(".bin"):
                out = os.path.join(dst, f.replace(".bin", ".npy"))
                if not os.path.exists(out):   # resumable, like the reference
                    jobs.append((os.path.join(src, f), out))
    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(lambda j: prepare_frame(j[0], j[1], voxel=voxel,
                                            native=native), jobs))
    return len(jobs)


def kitti_png_to_npy(root: str, out_root: str, sequences=None, *,
                     workers: int = 8) -> int:
    """``image_2|3/*.png`` -> uint8 RGB ``.npy``
    (``data/kitti_png_to_npy.py``)."""
    sequences = sequences if sequences is not None else list(range(11))
    jobs = []
    for seq in sequences:
        for cam in ("image_2", "image_3"):
            src = os.path.join(root, "sequences", f"{seq:02d}", cam)
            dst = os.path.join(out_root, "sequences", f"{seq:02d}", cam)
            if not os.path.isdir(src):
                continue
            os.makedirs(dst, exist_ok=True)
            for f in sorted(os.listdir(src)):
                if f.endswith(".png"):
                    out = os.path.join(dst, f.replace(".png", ".npy"))
                    if not os.path.exists(out):
                        jobs.append((os.path.join(src, f), out))

    def one(j):
        np.save(j[1], read_png(j[0]))

    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(one, jobs))
    return len(jobs)


def kitti_poses_to_npz(poses_txt: str, out_dir: str) -> int:
    """Odometry ``poses/XX.txt`` -> per-frame ``XXXXXX.npz{pose: 4x4}``."""
    os.makedirs(out_dir, exist_ok=True)
    mats = np.loadtxt(poses_txt).reshape(-1, 3, 4)
    for i, m in enumerate(mats):
        P = np.eye(4, dtype=np.float32)
        P[:3] = m
        np.savez(os.path.join(out_dir, f"{i:06d}.npz"), pose=P)
    return len(mats)


def prepare_frame_in_img_frame(bin_path: str, out_path: str, Pc: np.ndarray,
                               K: np.ndarray, img_shape, *,
                               voxel: float = 0.1, normal_k: int = 16,
                               native: bool = True) -> int:
    """bin -> npy with the cloud transformed into the CAMERA frame and
    cropped to the image frustum (``data/kitti/kitti_pc_bin_to_npy_in_img_
    frame.py`` variant)."""
    raw = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
    pc_cam = raw[:, :3] @ Pc[:3, :3].T + Pc[:3, 3]
    pc_cam, (inten,) = crop_pc_with_img(pc_cam, [raw[:, 3:4]], img_shape, K)
    pc_d, inten_d = _voxel(pc_cam, voxel, inten, native)
    return _save_cloud(out_path, pc_d, inten_d, normal_k, native)


def accumulate_frames_offline(pc_dir: str, pose_dir: str, out_dir: str, *,
                              frame_num: int = 3, skip: int = 6,
                              voxel: float = 0.4,
                              native: bool = True) -> int:
    """Offline accumulated-cloud variant
    (``data/kitti/frame_accumulation.py:52-173``): for every frame, fuse
    +-frame_num neighbours at the given stride into its frame and voxel
    downsample, writing ``<out>/<ffffff>.npy`` (7xN)."""
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(pc_dir) if f.endswith(".npy"))
    n = len(files)

    def pose(i):
        return np.load(os.path.join(pose_dir, f"{i:06d}.npz"))["pose"]

    written = 0
    for i in range(n):
        out_path = os.path.join(out_dir, f"{i:06d}.npy")
        if os.path.exists(out_path):
            continue
        P_io = np.linalg.inv(pose(i))
        parts = []
        for j in range(i - frame_num * skip, i + frame_num * skip + 1, skip):
            if j < 0 or j >= n:
                continue
            d = np.load(os.path.join(pc_dir, f"{j:06d}.npy"))
            T = P_io @ pose(j)
            xyz = (T[:3, :3] @ d[:3] + T[:3, 3:4])
            sn = T[:3, :3] @ d[4:7]
            parts.append(np.concatenate([xyz, d[3:4], sn], axis=0))
        acc = np.concatenate(parts, axis=1)
        pc_d, extra_d = _voxel(acc[:3].T.astype(np.float32), voxel,
                               acc[3:].T.astype(np.float32), native)
        np.save(out_path, np.concatenate([pc_d.T, extra_d.T],
                                         axis=0).astype(np.float32))
        written += 1
    return written
