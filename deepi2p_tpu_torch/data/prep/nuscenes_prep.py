"""nuScenes offline pairing list, the port's numpy copy of the JAX
package's ``data/prep/nuscenes_prep.py``.

Replaces ``data/nuscenes/make_datasets.py``: filters daytime scenes
(including the reference's explicit 18 hardcoded test night-scene tokens,
``make_datasets.py:12-30``, and the description keyword check, ``:50-55``),
walks each scene's LiDAR stream at ``frame_skip``, and for every LiDAR
sample_data collects, per camera, the nearby camera sample_data tokens
whose ego position is within ``max_translation`` — pickled as
``dataset_info.list``, the file the JAX package's ``NuScenesLoader``
consumes (``make_datasets.py:79-155,190-196``); the port's
:class:`~deepi2p_tpu_torch.data.NuScenesLoader` reads the same file.

:func:`detect_night_scene` reproduces the brightness heuristic the
reference used to build the token list in the first place
(``data/nuscenes/get_night_scenes_for_test.py:25-43``), so new datasets
can regenerate it without the hardcoded tokens.
"""
from __future__ import annotations

import pickle
from typing import List, Sequence

import numpy as np

from ..nuscenes import CAMERA_NAMES

# The 18 test-set night scenes the reference excludes by token
# (``data/nuscenes/make_datasets.py:12-30``; generated there by the
# brightness heuristic of ``get_night_scenes_for_test.py``).
TEST_NIGHT_SCENE_TOKENS = frozenset((
    "e59a4d0cc6a84ed59f78fb21a45cdcb4",
    "7209495d06f24712a063ac6c4a9b403b",
    "3d776ea805f240bb925bd9b50b258416",
    "48f81c548d0148fc8010a73d70b2ef9c",
    "2ab683f384234dce89800049dec19a30",
    "7edca4c44eac4f52a3105e1794e56b7e",
    "81c939ce8c0d4cc7b159cb5ed4c4e712",
    "24e6e64ecf794be4a51f7454c8b6d0b2",
    "828ed34a5e0c456fbf0751cabbab3341",
    "edfd6cfd1805477fbeadbd29f39ed599",
    "7692a3e112b44b408d191e45954a813c",
    "58d27a9f83294d99a4ff451dcad5f4d2",
    "a1573aef0bf74324b373dd8a22b4dd68",
    "ba06095d4e2e425b8e398668abc301d8",
    "7c315a1db2ac49439d281605f3cca6be",
    "732d7a84353f4ada803a9a115728496c",
    "1630a1d9cf8a46b3843662a23126e3f6",
    "f437809584344859882bdff7f8784c43",
))

NIGHT_SCENE_KEYWORDS = ("night", "Night")


def is_day_scene(scene_record: dict,
                 night_tokens: Sequence[str] = TEST_NIGHT_SCENE_TOKENS
                 ) -> bool:
    """Daytime filter (``make_datasets.py:50-55``): a scene is excluded if
    its description mentions night OR its token is on the explicit list."""
    if scene_record.get("token") in night_tokens:
        return False
    desc = scene_record.get("description", "")
    return not any(k in desc for k in NIGHT_SCENE_KEYWORDS)


def detect_night_scene(first_cam_front_gray: np.ndarray, *,
                       mean_threshold: float = 110.0,
                       white_level: int = 150,
                       white_area_fraction: float = 0.1) -> bool:
    """Brightness heuristic for night scenes
    (``get_night_scenes_for_test.py:30-43``): dark mean AND few bright
    pixels (headlights / street lamps don't count as daylight).

    Args:
      first_cam_front_gray: grayscale (H, W) uint8 of the scene's first
        CAM_FRONT frame.
    """
    img = np.asarray(first_cam_front_gray, np.float32)
    white_area = float(np.sum(img > white_level))
    return bool(img.mean() < mean_threshold
                and white_area < img.size * white_area_fraction)


def build_dataset_info(nusc, *, max_translation: float = 10.0,
                       frame_skip: int = 2,
                       night_tokens: Sequence[str] = TEST_NIGHT_SCENE_TOKENS,
                       out_path: str | None = None) -> List:
    """For each kept LiDAR frame: {camera_name: [nearby camera tokens]}.

    The LiDAR stream is walked at ``frame_skip`` (the reference keeps every
    ``frame_skip``-th sample_data, ``make_datasets.py:32-45``).
    """
    def ego_pos(sd):
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        return np.asarray(pose["translation"])

    dataset = []
    for scene in nusc.scene:
        if not is_day_scene(scene, night_tokens):
            continue
        sample = nusc.get("sample", scene["first_sample_token"])
        # collect all camera sample_data per camera, with positions
        cams = {}
        for name in CAMERA_NAMES:
            sd = nusc.get("sample_data", sample["data"][name])
            toks, poss = [], []
            while sd is not None:
                toks.append(sd["token"])
                poss.append(ego_pos(sd))
                sd = (nusc.get("sample_data", sd["next"])
                      if sd["next"] else None)
            cams[name] = (toks, np.asarray(poss))
        # walk the lidar stream at frame_skip (make_datasets.py:38-45)
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        counter = 0
        while sd is not None:
            keep = counter % frame_skip == 0
            counter += 1
            if keep:
                p = ego_pos(sd)
                nearby = {}
                ok = True
                for name, (toks, poss) in cams.items():
                    d = np.linalg.norm(poss - p, axis=1)
                    sel = [toks[i]
                           for i in np.nonzero(d < max_translation)[0]]
                    if not sel:
                        ok = False
                        break
                    nearby[name] = sel
                if ok:
                    dataset.append((sd["token"], nearby))
            sd = nusc.get("sample_data", sd["next"]) if sd["next"] else None
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(dataset, f)
    return dataset
