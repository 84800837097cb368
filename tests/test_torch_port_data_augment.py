"""The port's OpenCV-free augmentation and image resize against the JAX
package's OpenCV-backed functions on seeded inputs.

* ``angles_to_rotation``, ``random_transform``, ``jitter`` and the frame
  conversions: bitwise.
* The resize (``base.resize_linear``, OpenCV's ``INTER_LINEAR``): within
  one level on uint8 (it is exact here); on float32 bitwise against
  OpenCV's own kernels and within 1e-3 (relative) of its default IPP
  kernels, which round the float weights differently.
* Each colour op, and ``color_jitter`` as a whole: within one level of the
  JAX op on uint8 images, within 1e-3 on float input where the op's
  output is float (saturation); the generator at the same next draw.
* The HSV conversions against ``cv2.cvtColor``, bitwise over all 2^24
  uint8 inputs.
"""
import contextlib

import cv2
import numpy as np
import pytest

from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import augmentation as jax_aug
from deepi2p_tpu.data import base as jax_base
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import augmentation as aug
from deepi2p_tpu_torch.data import base


@contextlib.contextmanager
def ipp(on: bool):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def test_geometry_bitwise():
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        ang = a.uniform(-3, 3, 3)
        b.uniform(-3, 3, 3)
        np.testing.assert_array_equal(aug.angles_to_rotation(ang),
                                      jax_aug.angles_to_rotation(ang))
        amp = ((1.0, 0.0, 2.0), (0.1, np.pi, 0.0))
        np.testing.assert_array_equal(aug.random_transform(b, *amp),
                                      jax_aug.random_transform(a, *amp))
        x = a.normal(size=(100, 3)).astype(np.float32)
        b.normal(size=(100, 3))
        np.testing.assert_array_equal(aug.jitter(x, b), jax_aug.jitter(x, a))
        for f in ("cam_to_nwu", "nwu_to_cam", "enu_to_cam"):
            np.testing.assert_array_equal(getattr(aug, f)(x),
                                          getattr(jax_aug, f)(x))
        assert a.random() == b.random()


RESIZES = [((326, 1241), (620, 163)), ((200, 300), (150, 100)),
           ((150, 300), (77, 37)), ((800, 1600), (320, 160)),
           ((187, 211), (301, 299))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_opencv(src, dst):
    rng = np.random.default_rng(src[0])
    u8 = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    got = base.resize_linear(u8, *dst)
    want = cv2.resize(u8, dst, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3
    f32 = rng.uniform(0, 255, (*src, 3)).astype(np.float32)
    got = base.resize_linear(f32, *dst)
    with ipp(False):
        np.testing.assert_array_equal(
            got, cv2.resize(f32, dst, interpolation=cv2.INTER_LINEAR))
    with ipp(True):
        np.testing.assert_allclose(
            got, cv2.resize(f32, dst, interpolation=cv2.INTER_LINEAR),
            rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("train", [True, False])
def test_process_image_matches_jax(train):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (376, 1241, 3), dtype=np.uint8)
    K = np.array([[700.0, 0, 610], [0, 700.0, 180], [0, 0, 1]], np.float32)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    want = jax_base.process_image(img, K.copy(), jax_config.kitti(),
                                  train=train, rng=a)
    got = base.process_image(img, K.copy(), config.kitti(), train=train,
                             rng=b)
    assert got[0].shape == (160, 512, 3) and got[0].dtype == np.float32
    assert np.abs(got[0] - want[0]).max() <= 1
    np.testing.assert_array_equal(got[1], want[1])
    assert a.random() == b.random()


@pytest.mark.parametrize("conversion", ["RGB2HSV_FULL", "HSV2RGB_FULL"])
def test_hsv_conversions_match_opencv(conversion):
    fn = (aug.rgb_to_hsv_full if conversion == "RGB2HSV_FULL"
          else aug.hsv_full_to_rgb)
    levels = np.arange(256, dtype=np.uint8)
    for first in np.split(levels, 8):      # 2^21 inputs at a time
        every = np.stack(np.meshgrid(first, levels, levels, indexing="ij"),
                         -1).reshape(-1, 4096, 3)
        np.testing.assert_array_equal(
            fn(every),
            cv2.cvtColor(every, getattr(cv2, "COLOR_" + conversion)))


OPS = [("_adjust_brightness", (0.8, 1.2)), ("_adjust_contrast", (0.8, 1.2)),
       ("_adjust_saturation", (0.8, 1.2)), ("_adjust_hue", (-0.1, 0.1))]


@pytest.mark.parametrize("name,rng_range", OPS)
@pytest.mark.parametrize("whole", [True, False])
def test_color_ops_match_jax(name, rng_range, whole):
    """One op at 8 drawn factors, on an image of whole levels (as the
    jitter sees it after a uint8 image) or of fractions."""
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    if whole:
        img = np.floor(img)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(8):
        fa, fb = a.uniform(*rng_range), b.uniform(*rng_range)
        want = getattr(jax_aug, name)(img, fa)
        got = getattr(aug, name)(img, fb)
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = 1e-3 if name == "_adjust_saturation" else 1.0
        assert np.abs(got - want).max() <= tol
    assert a.random() == b.random()


def test_color_jitter_matches_jax():
    img = np.random.default_rng(8).integers(0, 256, (160, 512, 3),
                                            dtype=np.uint8)
    for seed in range(12):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_aug.color_jitter(img, a)
        got = aug.color_jitter(img, b)
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1
        assert a.random() == b.random()
