"""The port's KITTI, Oxford and nuScenes loaders against the JAX package's
on the fake trees of ``tests/test_data.py`` and
``tests/test_nuscenes_tables.py``: the same seed and the same call order
(one worker) give every key bitwise and ``img`` within one grey level
(OpenCV's resize and colour ops against the port's numpy copies of them;
on these trees the images too are bitwise), and leave both generators at
the same next draw.  Each case runs twice: with the
numpy node sampler on both sides (the JAX package's native library
pinned off) and with the native core the port builds loaded into both."""
import shutil

import numpy as np
import pytest

import deepi2p_tpu.data.native as jax_native
from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import KittiLoader as JaxKitti
from deepi2p_tpu.data import NuScenesLoader as JaxNuScenes
from deepi2p_tpu.data import OxfordLoader as JaxOxford
from deepi2p_tpu.data.nuscenes import tables_backend as jax_tables_backend
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import KittiLoader, NuScenesLoader, OxfordLoader
from deepi2p_tpu_torch.data import native as port_native
from deepi2p_tpu_torch.data.nuscenes import tables_backend
from torch_port_data_trees import (CAMERA_NAMES, FakeNuScenes,
                                   fake_nuscenes_dataset, kitti_tree,
                                   mini_nuscenes, oxford_tree)

SMALL = dict(input_pt_num=256, node_a_num=16, node_b_num=16)
KITTI = dict(SMALL, accumulation_frame_num=1, accumulation_frame_skip=2,
             delta_ij_max=5)


@pytest.fixture(params=["numpy", "native"])
def native(request, monkeypatch):
    """False: the numpy sampler on both sides; True: the port's built
    native core in both packages."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "_TRIED", True)
        return False
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native core cannot be built")
    monkeypatch.setenv("DEEPI2P_NATIVE_LIB", str(port_native.build()))
    monkeypatch.setattr(jax_native, "_TRIED", False)
    assert jax_native.available()
    return True


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    kitti = kitti_tree(base / "kitti", rng, seqs=("00", "09"))
    oxford = oxford_tree(base / "oxford", rng)
    (base / "nusc").mkdir()
    lidar, cams = mini_nuscenes(str(base / "nusc"), rng)
    yield dict(kitti=kitti, oxford=oxford, nusc=str(base / "nusc"),
               nusc_tokens=(lidar, cams))
    shutil.rmtree(base, ignore_errors=True)


def assert_same_samples(jax_loader, port_loader, n=None):
    n = len(jax_loader) if n is None else n
    assert len(jax_loader) == len(port_loader)
    for i in range(n):
        want, got = jax_loader[i], port_loader[i]
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            if k == "img":
                assert np.abs(got[k] - want[k]).max() <= 1.0, i
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port_loader.rng.random() == jax_loader.rng.random()


@pytest.mark.parametrize("mode", ["train", "val", "val_random_Ry"])
def test_kitti_loader_matches_jax(trees, native, mode):
    split = "train" if mode == "train" else "val"
    jax_ld = JaxKitti(trees["kitti"], split,
                      jax_config.tiny().replace(**KITTI), seed=3)
    port_ld = KittiLoader(trees["kitti"], split,
                          config.tiny().replace(**KITTI), seed=3,
                          native=native)
    jax_ld.mode = port_ld.mode = mode
    assert len(port_ld) == 12
    assert_same_samples(jax_ld, port_ld)


@pytest.mark.parametrize("mode", ["train", "val", "val_random_Ry"])
def test_oxford_loader_matches_jax(trees, native, mode):
    jax_ld = JaxOxford(trees["oxford"], mode,
                       jax_config.tiny().replace(**SMALL), seed=5)
    port_ld = OxfordLoader(trees["oxford"], mode,
                           config.tiny().replace(**SMALL), seed=5,
                           native=native)
    assert len(port_ld) == 6
    assert_same_samples(jax_ld, port_ld)


@pytest.mark.parametrize("mode", ["train", "val_random_Ry"])
def test_nuscenes_loader_fake_backend_matches_jax(native, mode):
    kw = dict(SMALL, accumulation_frame_num=2, accumulation_frame_skip=2,
              crop_original_top_rows=20)
    jax_ld = JaxNuScenes("/nonexistent", mode, jax_config.tiny().replace(**kw),
                         backend=FakeNuScenes(), seed=1,
                         dataset=fake_nuscenes_dataset())
    port_ld = NuScenesLoader("/nonexistent", mode, config.tiny().replace(**kw),
                             backend=FakeNuScenes(), seed=1,
                             dataset=fake_nuscenes_dataset(), native=native)
    assert_same_samples(jax_ld, port_ld)


def test_nuscenes_loader_tables_backend_matches_jax(trees, native):
    """The schema-faithful tree through each package's table reader, in
    both modes; the JPEG decode is OpenCV's on the JAX side and the port's
    own decoder on the other."""
    lidar, cams = trees["nusc_tokens"]
    dataset = [(tok, {name: [cams[name]] for name in CAMERA_NAMES})
               for tok in lidar[::2]]
    kw = dict(input_pt_num=256, node_a_num=8, node_b_num=8,
              accumulation_frame_num=2, accumulation_frame_skip=2)
    root = trees["nusc"]
    for mode in ("train", "val_random_Ry"):
        jax_ld = JaxNuScenes(root, mode, jax_config.nuscenes().replace(**kw),
                             backend=jax_tables_backend(root, "v1.0-trainval"),
                             dataset=dataset, seed=2)
        port_ld = NuScenesLoader(root, mode, config.nuscenes().replace(**kw),
                                 backend=tables_backend(root, "v1.0-trainval"),
                                 dataset=dataset, seed=2, native=native)
        assert_same_samples(jax_ld, port_ld)
