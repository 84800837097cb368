"""nuScenes table reader (numpy, no devkit), the port's copy of the JAX
package's ``data/nuscenes_tables.py``.

The slice of the nuscenes-devkit the pipeline touches
(``data/nuscenes/make_datasets.py:32-155``,
``data/nuscenes_pc_img_pose_loader.py:100-408`` of the reference) is
record walking over the published v1.0 schema: JSON tables keyed by
token, the devkit's derived ``sample["data"]`` index, a quaternion ->
matrix conversion (pyquaternion's) and the ``.pcd.bin`` reader
(``LidarPointCloud.from_file``).

Schema facts encoded here (nuScenes v1.0):
  * each table ``t`` is ``{dataroot}/{version}/{t}.json``, a list of
    records each with a unique ``"token"``;
  * ``sample_data`` records chain by ``prev``/``next`` (empty string at
    the ends) and point at ``ego_pose`` / ``calibrated_sensor`` records;
    ``filename`` is relative to ``dataroot``;
  * the devkit derives ``sample["data"][channel]`` for key frames
    (``NuScenes.__make_reverse_index__``); the channel comes from
    ``sensor[calibrated_sensor[sd].sensor_token].channel``;
  * lidar ``.pcd.bin`` files are flat float32 ``(x, y, z, intensity,
    ring)``; the first 4 are kept;
  * ``rotation`` quaternions are ``[w, x, y, z]``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


def quaternion_rotation_matrix(wxyz) -> np.ndarray:
    """[w, x, y, z] unit quaternion -> 3x3 rotation (pyquaternion semantics:
    normalises first)."""
    q = np.asarray(wxyz, np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def pose_matrix(record: dict) -> np.ndarray:
    """ego_pose / calibrated_sensor record -> homogeneous 4x4 float32."""
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = quaternion_rotation_matrix(record["rotation"])
    P[:3, 3] = record["translation"]
    return P


def read_lidar_bin(path: str):
    """nuScenes ``.pcd.bin`` -> ``(pc (N, 3) f32, intensity (N, 1) f32)``.

    Matches ``LidarPointCloud.from_file``'s decode (flat float32, 5 dims
    per point, first 4 kept) with the loader-facing (N, C) layout.
    """
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3:4])


class NuScenesTables:
    """Token-indexed view of a nuScenes table directory.

    API-compatible with the ``nuscenes.nuscenes.NuScenes`` surface the
    pipeline uses: ``.dataroot``, ``.version``, ``.scene`` and
    ``.get(table, token)``; tables load lazily so a trimmed download (e.g.
    no ``map.json``) still works.
    """

    def __init__(self, version: str, dataroot: str, verbose: bool = False):
        self.version, self.dataroot = version, dataroot
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        self._samples_indexed = False
        if verbose:
            print(f"NuScenesTables: {dataroot}/{version}")

    # -- raw tables ------------------------------------------------------
    def table(self, name: str) -> List[dict]:
        if name not in self._tables:
            path = os.path.join(self.dataroot, self.version, name + ".json")
            with open(path) as f:
                records = json.load(f)
            self._tables[name] = records
            self._index[name] = {r["token"]: r for r in records}
        return self._tables[name]

    @property
    def scene(self) -> List[dict]:
        return self.table("scene")

    @property
    def sample(self) -> List[dict]:
        self._index_samples()
        return self.table("sample")

    @property
    def sample_data(self) -> List[dict]:
        return self.table("sample_data")

    def get(self, table: str, token: str) -> dict:
        if table == "sample":
            self._index_samples()
        self.table(table)
        return self._index[table][token]

    # -- the devkit's derived reverse index ------------------------------
    def _index_samples(self) -> None:
        """Decorate ``sample["data"][channel]`` and ``sample_data
        ["channel"]`` exactly as ``NuScenes.__make_reverse_index__`` does
        (key frames only populate ``sample["data"]``)."""
        if self._samples_indexed:
            return
        self._samples_indexed = True
        self.table("sample")
        for rec in self.table("sample"):
            rec.setdefault("data", {})
        for sd in self.table("sample_data"):
            calib = self.get("calibrated_sensor",
                             sd["calibrated_sensor_token"])
            channel = self.get("sensor", calib["sensor_token"])["channel"]
            sd["channel"] = channel
            if sd.get("is_key_frame"):
                self._index["sample"][sd["sample_token"]]["data"][channel] \
                    = sd["token"]
