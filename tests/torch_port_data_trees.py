"""Fake dataset trees for the port's data tests: copies of the recipes in
``tests/test_data.py`` (KITTI, Oxford, the fake nuScenes backend) and
``tests/test_nuscenes_tables.py`` (a schema-faithful nuScenes tree), so
both packages' loaders read the same files."""
import json
import math
import os

import numpy as np

CAMERA_NAMES = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]


def kitti_tree(root, rng, seqs=("09",), n=86, img_dtype=np.float32):
    """KITTI layout with ``n`` frames per sequence (40 skipped at each end:
    86 -> 6 frames, 12 samples per sequence); images (200, 300, 3)."""
    K = [200.0, 0.0, 100.0, 0.0,
         0.0, 200.0, 60.0, 0.0,
         0.0, 0.0, 1.0, 0.0]
    tr = [0.0, -1.0, 0.0, 0.0,
          0.0, 0.0, -1.0, 0.0,
          1.0, 0.0, 0.0, 0.0]  # NWU -> cam-ish extrinsic
    for seq in seqs:
        (root / "calib" / seq).mkdir(parents=True)
        lines = [key + ": " + " ".join(str(v) for v in K)
                 for key in ("P0", "P1", "P2", "P3")]
        lines.append("Tr: " + " ".join(str(v) for v in tr))
        (root / "calib" / seq / "calib.txt").write_text(
            "\n".join(lines) + "\n")
        pcdir = (root / "data_odometry_velodyne_NWU" / "sequences" / seq
                 / "voxel0.1-SNr0.6")
        img2 = root / "data_odometry_color_npy" / "sequences" / seq / "image_2"
        img3 = root / "data_odometry_color_npy" / "sequences" / seq / "image_3"
        posedir = root / "poses" / seq
        for d in (pcdir, img2, img3, posedir):
            d.mkdir(parents=True)
        img = rng.integers(0, 255, (200, 300, 3)).astype(img_dtype)
        for i in range(n):
            # NWU: x forward, points in front of the camera
            pts = np.concatenate([
                rng.uniform(2, 30, (1, 400)),
                rng.uniform(-10, 10, (2, 400)),
                rng.uniform(0, 1, (1, 400)),
                rng.normal(size=(3, 400)),
            ]).astype(np.float32)
            np.save(pcdir / f"{i:06d}.npy", pts)
            np.save(img2 / f"{i:06d}.npy", img)
            np.save(img3 / f"{i:06d}.npy", img)
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = 0.05 * i
            np.savez(posedir / f"{i:06d}.npz", pose=pose)
    return str(root)


def oxford_tree(root, rng, jpeg=None):
    """One traversal in train.txt and val.txt: 6 clouds, 24 JPEGs (a
    seeded picture written by ``cv2.imwrite``, or the bytes ``jpeg``)."""
    trav = root / "trav0"
    (trav / "lms_front").mkdir(parents=True)
    (trav / "stereo" / "centre").mkdir(parents=True)
    (root / "train.txt").write_text("trav0\n")
    (root / "val.txt").write_text("trav0\n")

    n_pc, n_cam = 6, 24
    pc_ts = np.arange(n_pc) * 1000 + 100
    cam_ts = np.arange(n_cam) * 250 + 50
    np.save(trav / "pc_timestamps.npy", pc_ts)
    np.save(trav / "camera_timestamps.npy", cam_ts)

    def poses(ts):
        out = np.tile(np.eye(4, dtype=np.float32), (len(ts), 1, 1))
        out[:, 0, 3] = np.asarray(ts) * 1e-3  # slow drift along x
        return out
    np.save(trav / "pc_poses.npy", poses(pc_ts))
    np.save(trav / "camera_poses.npy", poses(cam_ts))

    for ts in pc_ts:
        pts = rng.normal(scale=10, size=(4, 500)).astype(np.float32)
        np.save(trav / "lms_front" / f"{ts}.npy", pts)
    img = rng.integers(0, 255, (300, 400, 3), dtype=np.uint8)
    for ts in cam_ts:
        path = trav / "stereo" / "centre" / f"{ts}.jpg"
        if jpeg is None:
            import cv2
            cv2.imwrite(str(path), img)
        else:
            path.write_bytes(jpeg)
    return str(root)


class FakeNuScenes:
    """The fake backend of ``tests/test_data.py``; camera images are drawn
    from a generator seeded per call, so two backends give one stream."""

    def __init__(self, seed=0, n_frames=9):
        self.rng = np.random.default_rng(seed)
        self.chain = [f"ld{i}" for i in range(n_frames)]

    def lidar_points(self, token):
        r = np.random.default_rng(int(token[2:]) if token[2:].isdigit()
                                  else 99)
        pc = r.normal(scale=15, size=(600, 3)).astype(np.float32)
        inten = r.uniform(0, 1, (600, 1)).astype(np.float32)
        return pc, inten

    def ego_pose(self, token):
        i = int(token[2:]) if token.startswith("ld") else 0
        P = np.eye(4, dtype=np.float32)
        P[0, 3] = 0.5 * i
        return P

    def calibration(self, token):
        return np.eye(4, dtype=np.float32)

    def camera_K(self, token):
        return np.array([[400.0, 0, 200], [0, 400, 120], [0, 0, 1]],
                        np.float32)

    def camera_image(self, token):
        return self.rng.integers(0, 255, (300, 400, 3)).astype(np.uint8)

    def neighbor(self, token, direction):
        i = int(token[2:])
        j = i + (1 if direction == "next" else -1)
        return f"ld{j}" if 0 <= j < len(self.chain) else ""


def fake_nuscenes_dataset():
    return [(f"ld{i}", {name: ["cam0", "cam1"] for name in CAMERA_NAMES})
            for i in (3, 4, 5)]


def _yaw_quat(a):
    return [math.cos(a / 2), 0.0, 0.0, math.sin(a / 2)]


def mini_nuscenes(root, rng, version="v1.0-trainval", n_frames=8):
    """A schema-faithful one-scene nuScenes tree
    (``tests/test_nuscenes_tables.py``); returns (lidar tokens, camera
    tokens)."""
    import cv2

    os.makedirs(os.path.join(root, version), exist_ok=True)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)

    sensors = [{"token": "sen_lidar", "channel": "LIDAR_TOP",
                "modality": "lidar"}]
    calibs = [{"token": "cs_lidar", "sensor_token": "sen_lidar",
               "rotation": _yaw_quat(0.3), "translation": [0.9, 0.0, 1.8],
               "camera_intrinsic": []}]
    for name in CAMERA_NAMES:
        sensors.append({"token": f"sen_{name}", "channel": name,
                        "modality": "camera"})
        calibs.append({"token": f"cs_{name}", "sensor_token": f"sen_{name}",
                       "rotation": _yaw_quat(-0.2),
                       "translation": [1.5, 0.2, 1.5],
                       "camera_intrinsic": [[620.0, 0.0, 320.0],
                                            [0.0, 620.0, 176.0],
                                            [0.0, 0.0, 1.0]]})

    ego_poses, sample_datas, lidar_tokens = [], [], []
    img = (rng.uniform(size=(900, 1600, 3)) * 255).astype(np.uint8)
    cv2.imwrite(os.path.join(root, "samples/cam.jpg"), img)
    for i in range(n_frames):
        tok = f"lidar_{i:03d}"
        pts = rng.normal(size=(64, 5)).astype(np.float32) * 5.0
        pts[:, 3:] = np.abs(pts[:, 3:])
        fn = f"samples/{tok}.pcd.bin"
        pts.tofile(os.path.join(root, fn))
        ego_poses.append({"token": f"ep_{tok}",
                          "rotation": _yaw_quat(0.02 * i),
                          "translation": [2.0 * i, 0.1, 0.0]})
        sample_datas.append({
            "token": tok, "sample_token": "samp_0", "filename": fn,
            "ego_pose_token": f"ep_{tok}",
            "calibrated_sensor_token": "cs_lidar",
            "is_key_frame": i == 0,
            "prev": f"lidar_{i-1:03d}" if i > 0 else "",
            "next": f"lidar_{i+1:03d}" if i < n_frames - 1 else ""})
        lidar_tokens.append(tok)
    cam_tokens = {}
    for name in CAMERA_NAMES:
        tok = f"cam_{name}"
        ego_poses.append({"token": f"ep_{tok}", "rotation": _yaw_quat(0.05),
                          "translation": [1.0, 0.0, 0.0]})
        sample_datas.append({
            "token": tok, "sample_token": "samp_0",
            "filename": "samples/cam.jpg", "ego_pose_token": f"ep_{tok}",
            "calibrated_sensor_token": f"cs_{name}", "is_key_frame": True,
            "prev": "", "next": ""})
        cam_tokens[name] = tok

    tables = {
        "sensor": sensors,
        "calibrated_sensor": calibs,
        "ego_pose": ego_poses,
        "sample_data": sample_datas,
        "sample": [{"token": "samp_0", "timestamp": 0, "prev": "",
                    "next": "", "scene_token": "scene_0"}],
        "scene": [{"token": "scene_0", "log_token": "log_0",
                   "nbr_samples": 1, "first_sample_token": "samp_0",
                   "last_sample_token": "samp_0", "name": "scene-0001",
                   "description": "Sunny day, parked cars"}],
    }
    for name, records in tables.items():
        with open(os.path.join(root, version, name + ".json"), "w") as f:
            json.dump(records, f)
    return lidar_tokens, cam_tokens
