"""The port's nuScenes pairing list
(``deepi2p_tpu_torch/data/prep/nuscenes_prep.py``) against the JAX
package's on the devkit-free mini tree of ``tests/test_nuscenes_tables.py``
(``tests/torch_port_data_trees.py::mini_nuscenes``), read by each
package's own table reader: the pickled ``dataset_info.list`` is the same
bytes, with a night scene and a listed test-night token added to the
tree; and the brightness heuristic for night scenes gives the same
verdicts."""
import json

import numpy as np
import pytest

from deepi2p_tpu.data.nuscenes_tables import NuScenesTables as JaxTables
from deepi2p_tpu.data.prep import nuscenes_prep as jax_prep
from deepi2p_tpu_torch.data.nuscenes_tables import NuScenesTables
from deepi2p_tpu_torch.data.prep import nuscenes_prep
from torch_port_data_trees import mini_nuscenes
from torch_port_fixtures import one_torch_thread  # noqa: F401

VERSION = "v1.0-trainval"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The mini tree plus three scenes over the same sample: a day scene,
    a night one by its description and one on the test-night list."""
    root = tmp_path_factory.mktemp("nusc")
    mini_nuscenes(str(root), np.random.default_rng(0), version=VERSION)
    path = root / VERSION / "scene.json"
    scenes = json.loads(path.read_text())
    listed = sorted(nuscenes_prep.TEST_NIGHT_SCENE_TOKENS)[0]
    for token, desc in (("scene_day2", "Cloudy, peds"),
                        ("scene_night", "Night, rain, parked trucks"),
                        (listed, "Looks like a day scene")):
        scenes.append(dict(scenes[0], token=token, description=desc))
    path.write_text(json.dumps(scenes))
    return str(root)


@pytest.mark.parametrize("max_translation,frame_skip", [
    (10.0, 2), (4.5, 1), (1e9, 3), (0.5, 2)])
def test_build_dataset_info_is_the_jax_packages(tree, tmp_path,
                                                max_translation, frame_skip):
    kw = dict(max_translation=max_translation, frame_skip=frame_skip)
    want = jax_prep.build_dataset_info(
        JaxTables(VERSION, tree), out_path=str(tmp_path / "jax.list"), **kw)
    got = nuscenes_prep.build_dataset_info(
        NuScenesTables(VERSION, tree), out_path=str(tmp_path / "port.list"),
        **kw)
    assert got == want
    assert ((tmp_path / "port.list").read_bytes()
            == (tmp_path / "jax.list").read_bytes())
    if max_translation == 1e9:
        # two day scenes walked; the night and the listed one dropped
        assert len(got) == 2 * len(range(0, 8, frame_skip))


def test_day_filter_and_night_heuristic():
    for rec in ({"token": "a", "description": "Night, rain"},
                {"token": "b", "description": "night drive"},
                {"token": "c", "description": "Sunny"},
                {"token": "e59a4d0cc6a84ed59f78fb21a45cdcb4",
                 "description": "Sunny"}, {"token": "d"}):
        assert (nuscenes_prep.is_day_scene(rec)
                == jax_prep.is_day_scene(rec))
    rng = np.random.default_rng(3)
    verdicts = set()
    for mean in (40, 100, 109.5, 110, 140, 200):
        for bright in (0.0, 0.05, 0.1, 0.3):
            img = np.clip(rng.normal(mean, 5, (90, 160)), 0, 149)
            img[rng.random(img.shape) < bright] = 250
            img = img.astype(np.uint8)
            night = nuscenes_prep.detect_night_scene(img)
            assert night == jax_prep.detect_night_scene(img)
            verdicts.add(night)
    assert verdicts == {True, False}
