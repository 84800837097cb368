"""Oxford RobotCar offline dataset preparation, the port's copy of the JAX
package's ``data/prep/oxford_prep.py``, without OpenCV: images are decoded
by the port's :mod:`.oxford_image` and written by its JPEG encoder
(:func:`~..jpeg.write_jpeg`, the bytes of ``cv2.imwrite`` at its
defaults, which the JAX package calls).

Full re-implementation of the reference's offline pipeline
(``data/oxford/build_dataset.py:35-493``): integrate visual-odometry
relative poses, accumulate the 2D LMS-front scans into 3D clouds over a
100 m travel window, sample a cloud every ``pc_sample_distance`` metres,
filter stopped segments by velocity, voxel-downsample with reflectance
carried through, and write the traversal layout consumed by
:class:`~deepi2p_tpu_torch.data.OxfordLoader` (and the JAX package's):

    <out>/<traversal>/pc_timestamps.npy, pc_poses.npy (Nx4x4),
                      camera_timestamps.npy, camera_poses.npy,
                      lms_front/<ts>.npy (4xN: xyz + reflectance),
                      stereo/centre/<ts>.jpg

Every stage — VO csv parsing, SE(3) pose integration and interpolation,
LMS ``.bin`` scan decoding, ground removal, accumulation, voxel
downsampling, per-2 m sampling, velocity filtering, Bayer demosaicing,
LUT undistortion (:mod:`.oxford_image`), resumable layout writing,
night-traversal filtering and the multi-process fan-out — is implemented
from first principles (``build_dataset.py:249-390, 402-493``).  The only
external inputs are files: the raw dataset, the SDK ``extrinsics/*.txt``
and, for undistortion, the camera-model LUT binary (see
:class:`SdkInterface` / :func:`sdk_from_extrinsics`).
"""
from __future__ import annotations

import csv
import math
import os
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from ...ops.sampling import voxel_downsample_np
from ..jpeg import write_jpeg


# --------------------------------------------------------------------------
# SE(3) helpers (replace robotcar-sdk ``transform.py`` / ``interpolate_poses``)
# --------------------------------------------------------------------------

def build_se3_transform(xyzrpy: Sequence[float]) -> np.ndarray:
    """(x, y, z, roll, pitch, yaw) -> 4x4, R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
    (the RobotCar SDK euler convention used by ``build_dataset.py:72``)."""
    x, y, z, r, p, yw = [float(v) for v in xyzrpy]
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(yw), math.sin(yw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = (x, y, z)
    return T


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _slerp(q0: np.ndarray, q1: np.ndarray, a: float) -> np.ndarray:
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = float(np.clip(np.dot(q0, q1), -1.0, 1.0))
    if d > 0.9995:
        q = q0 + a * (q1 - q0)
        return q / np.linalg.norm(q)
    th = math.acos(d)
    return (math.sin((1 - a) * th) * q0 + math.sin(a * th) * q1) / math.sin(th)


def interpolate_poses(pose_timestamps: Sequence[int],
                      abs_poses: Sequence[np.ndarray],
                      requested_timestamps: Sequence[int],
                      origin_timestamp: int) -> List[np.ndarray]:
    """Interpolate absolute poses at the requested timestamps, expressed
    relative to the (interpolated) pose at ``origin_timestamp`` — the SDK
    ``interpolate_poses`` contract used at ``build_dataset.py:76``."""
    ts = list(pose_timestamps)

    def at(t: int) -> np.ndarray:
        i = bisect_left(ts, t)
        if i <= 0:
            return np.asarray(abs_poses[0], float)
        if i >= len(ts):
            return np.asarray(abs_poses[-1], float)
        lo, hi = ts[i - 1], ts[i]
        a = 0.0 if hi == lo else (t - lo) / (hi - lo)
        P0, P1 = np.asarray(abs_poses[i - 1], float), np.asarray(abs_poses[i], float)
        T = np.eye(4)
        T[:3, :3] = _quat_to_rot(_slerp(_rot_to_quat(P0[:3, :3]),
                                        _rot_to_quat(P1[:3, :3]), a))
        T[:3, 3] = (1 - a) * P0[:3, 3] + a * P1[:3, 3]
        return T

    origin_inv = np.linalg.inv(at(int(origin_timestamp)))
    return [origin_inv @ at(int(t)) for t in requested_timestamps]


# --------------------------------------------------------------------------
# VO integration (``build_dataset.py:35-76``)
# --------------------------------------------------------------------------

class VOManager:
    """Parses ``vo/vo.csv`` (rows: dest_ts, src_ts, x, y, z, r, p, yaw) and
    serves window-relative interpolated poses by chaining the relative
    transforms — the exact strategy of the reference's ``VOManager``."""

    def __init__(self, vo_path: str):
        self.timestamp_list: List[int] = []
        self.xyzrpy_list: List[List[float]] = []
        with open(vo_path) as f:
            reader = csv.reader(f)
            next(f)                                   # header line
            for row in reader:
                if not row:
                    continue
                self.timestamp_list.append(int(row[0]))
                self.xyzrpy_list.append([float(v) for v in row[2:8]])
        self.counter = len(self.timestamp_list)

    def interpolate_vo_poses(self, pose_timestamps: Sequence[int],
                             origin_timestamp: int) -> List[np.ndarray]:
        """Chain relative VO poses over the bracketing window, then
        interpolate (``build_dataset.py:54-76``)."""
        lower = min(min(pose_timestamps), origin_timestamp)
        upper = max(max(pose_timestamps), origin_timestamp)
        lo = max(0, bisect_left(self.timestamp_list, lower) - 1)
        hi = min(bisect_left(self.timestamp_list, upper), self.counter - 1)
        vo_ts = [self.timestamp_list[lo]]
        abs_poses = [np.eye(4)]
        for i in range(lo + 1, hi + 1):
            vo_ts.append(self.timestamp_list[i])
            abs_poses.append(abs_poses[-1]
                             @ build_se3_transform(self.xyzrpy_list[i]))
        return interpolate_poses(vo_ts, abs_poses, pose_timestamps,
                                 origin_timestamp)


# Backwards-compatible alias used by the SDK-independent stage tests.
def integrate_vo_poses(rel_poses: np.ndarray) -> np.ndarray:
    """Chain relative 4x4 VO transforms into absolute poses."""
    out = np.zeros((len(rel_poses) + 1, 4, 4), np.float64)
    out[0] = np.eye(4)
    for i, T in enumerate(rel_poses):
        out[i + 1] = out[i] @ T
    return out


# --------------------------------------------------------------------------
# LMS scan decoding + accumulation (``build_dataset.py:79-148``)
# --------------------------------------------------------------------------

def load_lms_scan(path: str) -> np.ndarray:
    """Raw LMS ``.bin`` -> (3, N): rows are (x, y, reflectance); x points to
    the ground (``build_dataset.py:127-137``)."""
    scan = np.fromfile(path, np.double)
    return scan.reshape((len(scan) // 3, 3)).T


def build_pointcloud_window(G_posesource_laser: np.ndarray,
                            lidar_dir: str,
                            vo_manager: VOManager,
                            timestamps: Sequence[int],
                            origin_time: int, *,
                            skip_threshold: Optional[float] = None,
                            remove_ground_threshold: Optional[float] = None):
    """Accumulate LMS scans into the origin frame (``:79-148``).

    Returns (pointcloud (4, N) homogeneous, reflectance (N,), skip_counter).
    """
    if len(timestamps) == 0:
        raise ValueError("No LIDAR data in the given time bracket.")
    poses = vo_manager.interpolate_vo_poses(timestamps, origin_time)

    chunks, refls = [], []
    previous_pose, skip_counter = None, 0
    for i, ts in enumerate(timestamps):
        scan_path = os.path.join(lidar_dir, f"{ts}.bin")
        if not os.path.isfile(scan_path):
            continue
        if previous_pose is not None and skip_threshold is not None:
            delta = np.linalg.inv(previous_pose) @ poses[i]
            if np.linalg.norm(delta[:3, 3]) < skip_threshold:
                skip_counter += 1
                continue
        scan = load_lms_scan(scan_path)
        if remove_ground_threshold is not None and remove_ground_threshold > -1:
            scan = scan[:, scan[0] < remove_ground_threshold]
        refls.append(scan[2].copy())
        scan = scan.copy()
        scan[2] = 0.0                                   # 2D scanner plane
        hom = np.vstack([scan, np.ones((1, scan.shape[1]))])
        chunks.append((poses[i] @ G_posesource_laser) @ hom)
        previous_pose = poses[i]

    if not chunks:
        raise IOError(f"Could not find scan files in {lidar_dir}")
    return (np.concatenate(chunks, axis=1),
            np.concatenate(refls), skip_counter)


def downsample(pointcloud: np.ndarray, reflectance: np.ndarray,
               voxel: float):
    """Voxel-grid downsample carrying reflectance through (the reference
    abuses an Open3D color channel for this, ``build_dataset.py:151-166``)."""
    pts, refl = voxel_downsample_np(pointcloud[:3].T, voxel,
                                    reflectance.reshape(-1, 1))
    hom = np.concatenate([pts.T, np.ones((1, pts.shape[0]))], axis=0)
    return hom, refl.reshape(-1)


def remove_ground(pc: np.ndarray, reflectance: np.ndarray,
                  z_threshold: float = 0.1):
    """Post-hoc ground removal for already-built (N, 3) clouds."""
    keep = pc[:, 2] > z_threshold
    return pc[keep], reflectance[keep]


def velocity_filter(poses: np.ndarray, timestamps: np.ndarray,
                    min_speed: float = 0.2) -> np.ndarray:
    """Boolean mask of frames where the vehicle is moving."""
    t = np.asarray(timestamps, np.float64) * 1e-6
    pos = poses[:, :3, 3]
    keep = np.ones(len(poses), bool)
    for i in range(1, len(poses)):
        dt = max(t[i] - t[i - 1], 1e-6)
        keep[i] = np.linalg.norm(pos[i] - pos[i - 1]) / dt > min_speed
    return keep


def accumulate_scans(scan_points: List[np.ndarray],
                     scan_poses: List[np.ndarray],
                     center_pose: np.ndarray) -> np.ndarray:
    """Fuse per-scan (Ni, 4) xyz+refl points into the centre frame."""
    inv = np.linalg.inv(center_pose)
    out = []
    for pts, pose in zip(scan_points, scan_poses):
        T = inv @ pose
        xyz = pts[:, :3] @ T[:3, :3].T + T[:3, 3]
        out.append(np.concatenate([xyz, pts[:, 3:4]], axis=1))
    return np.concatenate(out, axis=0)


# --------------------------------------------------------------------------
# The narrow raw-decode interface
# --------------------------------------------------------------------------

@dataclass
class SdkInterface:
    """Everything :func:`build_traversal` needs from the
    robotcar-dataset-sdk.

    ``load_image(path) -> RGB uint8 (H, W, 3)`` performs Bayer demosaicing +
    camera-model undistortion; the three extrinsic transforms come from the
    SDK's ``extrinsics/*.txt`` (each one line of xyzrpy, parseable with
    :func:`build_se3_transform`).  A fake instance drives the tests.
    """
    load_image: Callable[[str], np.ndarray]
    G_camera_image: np.ndarray = field(default_factory=lambda: np.eye(4))
    G_camera_vehicle: np.ndarray = field(default_factory=lambda: np.eye(4))
    G_posesource_laser: np.ndarray = field(default_factory=lambda: np.eye(4))
    image_ext: str = ".png"


def sdk_from_extrinsics(extrinsics_dir: str,
                        load_image: Optional[Callable[[str], np.ndarray]]
                        = None,
                        camera: str = "stereo",
                        lidar: str = "lms_front",
                        G_camera_image: Optional[np.ndarray] = None,
                        lut_path: Optional[str] = None) -> SdkInterface:
    """Build the interface from SDK-format extrinsics txt files.

    With ``load_image=None`` the first-principles decoder is used
    (:mod:`.oxford_image`: Bayer demosaic + optional LUT undistortion), so
    the external surface shrinks to pure file reads — the extrinsics txt
    and, optionally, the camera-model LUT binary."""
    if load_image is None:
        from .oxford_image import BAYER_STEREO, BAYER_MONO, make_load_image
        pattern = BAYER_STEREO if "stereo" in camera else BAYER_MONO
        load_image = make_load_image(lut_path=lut_path, pattern=pattern)

    def read(name):
        with open(os.path.join(extrinsics_dir, name + ".txt")) as f:
            return build_se3_transform([float(x) for x in next(f).split()])
    return SdkInterface(
        load_image=load_image,
        G_camera_image=(np.eye(4) if G_camera_image is None
                        else np.asarray(G_camera_image, float)),
        G_camera_vehicle=read(camera),
        G_posesource_laser=read(lidar))


# --------------------------------------------------------------------------
# Per-traversal orchestration (``build_dataset.py:169-390``)
# --------------------------------------------------------------------------

def _read_timestamps(path: str) -> List[int]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(int(line.split()[0]))
    return out


def build_traversal(traversal: str,
                    raw_lms_root: str,
                    raw_root: str,
                    out_root: str,
                    sdk: SdkInterface, *,
                    is_build_pc: bool = True,
                    is_build_img: bool = True,
                    remove_ground_threshold: Optional[float] = 0.1,
                    pc_sample_distance: float = 2.0,
                    min_vehicle_velocity: float = 0.2,
                    accumulation_distance: float = 100.0,
                    ignore_first_n_second: float = 20.0,
                    voxel_grid_downsample_size: float = 0.1,
                    lidar_hz: float = 50.0,
                    verbose: bool = False) -> dict:
    """Build one traversal's clouds + decoded images + pose tables.

    Mirrors ``save_pc_img_for_traversal`` (``build_dataset.py:169-390``):
    resumable (skips clouds/images whose output file already exists) and
    returns a summary dict {'n_pc', 'n_img'} for :func:`build_dataset`.
    """
    image_dir = os.path.join(raw_root, traversal, "stereo", "centre")
    lidar_dir = os.path.join(raw_lms_root, traversal, "lms_front")
    G_camera_image_inv = np.linalg.inv(sdk.G_camera_image)
    G_camera_posesource = sdk.G_camera_vehicle      # VO frame == vehicle

    # timestamps ---------------------------------------------------------
    cam_ts_path = os.path.join(image_dir, os.pardir, "stereo.timestamps")
    if not os.path.isfile(cam_ts_path):
        cam_ts_path = os.path.join(image_dir, os.pardir, os.pardir,
                                   "stereo.timestamps")
    camera_timestamp_list = _read_timestamps(cam_ts_path)
    lidar_timestamps_list = _read_timestamps(
        os.path.join(lidar_dir, os.pardir, "lms_front.timestamps"))

    vo_manager = VOManager(os.path.join(raw_root, traversal, "vo", "vo.csv"))

    # drop the first seconds (VO initialisation, ``:232-239``) ------------
    init_idx = 0
    for idx, ts in enumerate(camera_timestamp_list):
        if ts - camera_timestamp_list[0] > ignore_first_n_second * 1e6:
            init_idx = idx
            break
    camera_timestamp_list = camera_timestamp_list[init_idx:]

    summary = {"n_pc": 0, "n_img": 0}
    if is_build_pc:
        folder = ("lms_front_foreground" if remove_ground_threshold is not None
                  else "lms_front")
        out_pc = os.path.join(out_root, traversal, folder)
        os.makedirs(out_pc, exist_ok=True)
        # also write the canonical folder name the loader defaults to
        canonical = os.path.join(out_root, traversal, "lms_front")
        os.makedirs(canonical, exist_ok=True)

        # per-``pc_sample_distance`` camera indices (``:249-263``) --------
        per_meter_idx = [0]
        for idx in range(1, len(camera_timestamp_list)):
            rel = vo_manager.interpolate_vo_poses(
                [camera_timestamp_list[idx]],
                camera_timestamp_list[per_meter_idx[-1]])
            if np.linalg.norm(rel[0][:3, 3]) >= pc_sample_distance:
                per_meter_idx.append(idx)

        # accumulate a window per node (``:265-323``) ----------------------
        margin = math.ceil(0.5 * accumulation_distance / pc_sample_distance)
        pc_center_ts: List[int] = []
        for i in range(margin, len(per_meter_idx) - margin):
            back_ts = camera_timestamp_list[per_meter_idx[i - margin]]
            center_ts = camera_timestamp_list[per_meter_idx[i]]
            front_ts = camera_timestamp_list[per_meter_idx[i + margin]]
            lo = bisect_left(lidar_timestamps_list, back_ts)
            hi = bisect_right(lidar_timestamps_list, front_ts)
            acc_ts = lidar_timestamps_list[lo:hi]
            if not acc_ts:
                continue
            # 50 Hz scanner => velocity over the window (``:285-292``)
            velocity = accumulation_distance / (len(acc_ts) / lidar_hz)
            if velocity < min_vehicle_velocity:
                if verbose:
                    print(f"[PC] {traversal} velocity {velocity:.2f}, skip")
                continue
            out_file = os.path.join(out_pc, f"{center_ts}.npy")
            if os.path.isfile(out_file):                 # resume (``:294``)
                pc_center_ts.append(center_ts)
                continue
            cloud, refl, _skips = build_pointcloud_window(
                sdk.G_posesource_laser, lidar_dir, vo_manager, acc_ts,
                center_ts,
                skip_threshold=voxel_grid_downsample_size / 16.0,
                remove_ground_threshold=remove_ground_threshold)
            cloud, refl = downsample(cloud, refl, voxel_grid_downsample_size)
            # into the camera *image* frame (``:310``)
            cloud = (G_camera_image_inv @ G_camera_posesource) @ cloud
            out = np.concatenate(
                [cloud[:3], refl[None, :]], axis=0).astype(np.float32)
            np.save(out_file, out)
            if folder != "lms_front":
                np.save(os.path.join(canonical, f"{center_ts}.npy"), out)
            pc_center_ts.append(center_ts)
            if verbose:
                print(f"[PC] {traversal} {center_ts}: {out.shape[1]} pts")

        if pc_center_ts:
            pc_poses = vo_manager.interpolate_vo_poses(
                pc_center_ts, camera_timestamp_list[0])
            np.save(os.path.join(out_root, traversal, "pc_timestamps.npy"),
                    np.asarray(pc_center_ts, np.int64))
            np.save(os.path.join(out_root, traversal, "pc_poses.npy"),
                    np.asarray(pc_poses, np.float64))
        summary["n_pc"] = len(pc_center_ts)

    if is_build_img:
        out_img = os.path.join(out_root, traversal, "stereo", "centre")
        os.makedirs(out_img, exist_ok=True)
        valid_ts: List[int] = []
        for ts in camera_timestamp_list:
            out_path = os.path.join(out_img, f"{ts}.jpg")
            if os.path.isfile(out_path):                 # resume (``:366``)
                valid_ts.append(ts)
                continue
            in_path = os.path.join(image_dir, f"{ts}{sdk.image_ext}")
            if not os.path.isfile(in_path):
                continue
            write_jpeg(out_path, np.asarray(sdk.load_image(in_path),
                                            np.uint8))
            valid_ts.append(ts)
        if valid_ts:
            cam_poses = vo_manager.interpolate_vo_poses(valid_ts, valid_ts[0])
            np.save(os.path.join(out_root, traversal,
                                 "camera_timestamps.npy"),
                    np.asarray(valid_ts, np.int64))
            np.save(os.path.join(out_root, traversal, "camera_poses.npy"),
                    np.asarray(cam_poses, np.float64))
        summary["n_img"] = len(valid_ts)
    return summary


# --------------------------------------------------------------------------
# Dataset-level fan-out (``build_dataset.py:402-493``)
# --------------------------------------------------------------------------

def read_tags_csv(csv_path: str) -> List[str]:
    tags: List[str] = []
    with open(csv_path) as f:
        for row in csv.reader(f):
            tags += row
    return tags


def build_dataset(raw_lms_root: str, raw_root: str, out_root: str,
                  sdk: SdkInterface, *,
                  processes: int = 1, verbose: bool = False,
                  **traversal_kwargs) -> List[str]:
    """Build every non-night, not-yet-done traversal; returns those built.

    Night traversals are excluded via ``tags.csv`` and completion is marked
    by copying ``tags.csv`` into the output traversal — exactly the
    reference's resume/skip protocol (``build_dataset.py:427-449, 489-492``).
    """
    import shutil

    traversals = sorted(
        f for f in os.listdir(raw_root)
        if os.path.isdir(os.path.join(raw_root, f)))
    todo = []
    for trav in traversals:
        tags_path = os.path.join(raw_root, trav, "tags.csv")
        if os.path.isfile(tags_path) and "night" in read_tags_csv(tags_path):
            continue                                        # night driving
        if os.path.exists(os.path.join(out_root, trav, "tags.csv")):
            continue                                        # already done
        todo.append(trav)

    def run(trav):
        build_traversal(trav, raw_lms_root, raw_root, out_root, sdk,
                        verbose=verbose, **traversal_kwargs)
        src = os.path.join(raw_root, trav, "tags.csv")
        os.makedirs(os.path.join(out_root, trav), exist_ok=True)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(out_root, trav, "tags.csv"))

    if processes <= 1:
        for trav in todo:
            run(trav)
    else:
        import multiprocessing
        for i in range(0, len(todo), processes):
            procs = [multiprocessing.Process(target=run, args=(t,))
                     for t in todo[i:i + processes]]
            for p in procs:
                p.start()
            for p in procs:
                p.join()
    return todo
