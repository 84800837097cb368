"""The port's Oxford prep (``deepi2p_tpu_torch/data/prep/oxford_image.py``,
``oxford_prep.py``) against the JAX package's, which decodes and writes
through OpenCV:

* ``demosaic`` bitwise the JAX one (its ``cv2.filter2D``), for the four
  Bayer patterns, odd sizes, 8- and 16-bit mosaics;
* ``undistort`` bitwise ``cv2.remap`` (and so within 1e-4 of it) on
  random fractional maps that reach outside the frame;
* ``make_load_image`` (raw Bayer PNG + LUT) in uint8, bitwise the JAX
  one; the values whose float lies within 1e-4 of a .5, where a
  resampler off by that much would round apart, are counted (2 of 9216
  at one seed here);
* ``build_traversal`` on the fake traversal of ``tests/test_oxford_prep.py``
  with real Bayer PNGs and a LUT: every ``.npy`` equal and every JPEG the
  same bytes; the SE(3) helpers and the LMS reader on the same inputs.
"""
import os

import cv2
import numpy as np
import pytest

from deepi2p_tpu.data.prep import oxford_image as jax_image
from deepi2p_tpu.data.prep import oxford_prep as jax_prep
from deepi2p_tpu_torch.data.prep import oxford_image, oxford_prep
from test_oxford_prep import BUILD_KW, _make_fake_traversal, _mosaic
from torch_port_fixtures import one_torch_thread  # noqa: F401

TRAV = "2015-01-01-00-00-00"


@pytest.mark.parametrize("pattern", ["gbrg", "rggb", "grbg", "bggr"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 7), (32, 40),
                                   (61, 83)])
def test_demosaic_is_bitwise_the_jax_packages(pattern, shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    for dtype, top in ((np.uint8, 256), (np.uint16, 65536)):
        raw = rng.integers(0, top, shape).astype(dtype)
        want = jax_image.demosaic(raw, pattern)
        got = oxford_image.demosaic(raw, pattern)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Bayer"):
        oxford_image.demosaic(raw, "rgbx")


def random_maps(rng, H, W, scale=1.0):
    """Fractional source coordinates over [-3, W+2) x [-3, H+2)."""
    u = rng.uniform(-3.0, W + 2.0, (H, W)) * scale
    v = rng.uniform(-3.0, H + 2.0, (H, W)) * scale
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3])
def test_undistort_is_cv2_remap(channels):
    rng = np.random.default_rng(4)
    H, W = 37, 53
    shape = (H, W) if channels is None else (H, W, channels)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    u, v = random_maps(rng, H, W)
    want = cv2.remap(img, u, v, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    got = oxford_image.undistort(img, u, v)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # integer coordinates, one pixel out and far out
    u[:] = np.arange(W)[None] - 1.0
    v[:] = 1e9
    v[:, :5] = np.arange(H)[:, None]
    np.testing.assert_array_equal(oxford_image.undistort(img, u, v),
                                  jax_image.undistort(img, u, v))


def write_lut(path, H, W, rng):
    """A smooth radial distortion plus a fractional jitter, as float64."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    cx, cy = (W - 1) / 2, (H - 1) / 2
    r2 = ((x - cx) ** 2 + (y - cy) ** 2) / (cx * cx + cy * cy)
    u = cx + (x - cx) * (1 + 0.08 * r2) + rng.uniform(-0.3, 0.3, (H, W))
    v = cy + (y - cy) * (1 + 0.08 * r2) + rng.uniform(-0.3, 0.3, (H, W))
    np.stack([u.ravel(), v.ravel()]).astype(np.double).tofile(path)


def bayer_png(path, H, W, rng, pattern="gbrg"):
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    rgb = np.stack([100 + 50 * np.sin(x / rng.uniform(3, 11)),
                    120 + 40 * np.cos(y / rng.uniform(3, 7)),
                    90 + 30 * np.sin((x + y) / 13.0)], axis=-1)
    rgb += rng.normal(0, 20, rgb.shape)
    raw = np.clip(_mosaic(np.clip(rgb, 0, 255), pattern), 0, 255)
    assert cv2.imwrite(str(path), raw.astype(np.uint8))


@pytest.mark.parametrize("pattern", ["gbrg", "rggb"])
def test_make_load_image_is_the_jax_packages(tmp_path, pattern):
    rng = np.random.default_rng(5)
    H, W = 48, 64
    lut = tmp_path / "lut.bin"
    write_lut(lut, H, W, rng)
    png = tmp_path / "raw.png"
    bayer_png(png, H, W, rng, pattern)
    got = oxford_image.make_load_image(str(lut), pattern)(str(png))
    want = jax_image.make_load_image(str(lut), pattern)(str(png))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (H, W, 3)
    # the float image both round: a value within 1e-4 of a .5 may round
    # either way, since cv2.remap is within 2.1e-5 of exact bilinear
    raw = cv2.imread(str(png), cv2.IMREAD_UNCHANGED)
    f = oxford_image.undistort(oxford_image.demosaic(raw, pattern),
                               *oxford_image.read_distortion_lut(
                                   str(lut), (H, W)))
    near_half = np.abs((f + 0.5) - np.round(f + 0.5)) < 1e-4
    near_half &= (f > -0.5) & (f < 254.5)
    # ~2e-4 of the values fall there by chance (2 of 9216 at this seed)
    assert int(near_half.sum()) <= 1e-3 * f.size
    np.testing.assert_array_equal(got, want)
    # no LUT: demosaic only, and a colour PNG passes through as RGB
    np.testing.assert_array_equal(
        oxford_image.make_load_image(None, pattern)(str(png)),
        jax_image.make_load_image(None, pattern)(str(png)))
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "rgb.png"), rgb[..., ::-1])
    np.testing.assert_array_equal(
        oxford_image.make_load_image(str(lut))(str(tmp_path / "rgb.png")),
        rgb)


def test_read_distortion_lut(tmp_path):
    rng = np.random.default_rng(6)
    write_lut(tmp_path / "lut.bin", 12, 20, rng)
    for a, b in zip(oxford_image.read_distortion_lut(str(tmp_path /
                                                         "lut.bin"),
                                                     (12, 20)),
                    jax_image.read_distortion_lut(str(tmp_path / "lut.bin"),
                                                  (12, 20))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        oxford_image.read_distortion_lut(str(tmp_path / "lut.bin"), (12, 21))


def tree_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_build_traversal_is_the_jax_packages(tmp_path):
    rng = np.random.default_rng(7)
    raw, lms = tmp_path / "raw", tmp_path / "lms"
    cam_ts, _ = _make_fake_traversal(str(raw), str(lms), TRAV, rng)
    H, W = 40, 56
    for ts in cam_ts:    # real Bayer frames in place of the empty PNGs
        bayer_png(raw / TRAV / "stereo" / "centre" / f"{ts}.png", H, W, rng)
    lut = tmp_path / "lut.bin"
    write_lut(lut, H, W, rng)
    ext = tmp_path / "extrinsics"
    ext.mkdir()
    (ext / "stereo.txt").write_text("0.1 0.2 0.3 0.01 0.02 0.03\n")
    (ext / "lms_front.txt").write_text("1 0 0.5 0 0 1.5708\n")
    summaries = {}
    for pkg, name in ((jax_prep, "jax"), (oxford_prep, "port")):
        sdk = pkg.sdk_from_extrinsics(str(ext), lut_path=str(lut))
        summaries[name] = pkg.build_traversal(
            TRAV, str(lms), str(raw), str(tmp_path / name), sdk, **BUILD_KW)
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["n_pc"] >= 3 and summaries["port"]["n_img"] > 30
    want, got = tree_files(tmp_path / "jax"), tree_files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    n_jpg = 0
    for rel, path in want.items():
        if rel.endswith(".jpg"):
            n_jpg += 1
            with open(path, "rb") as a, open(got[rel], "rb") as b:
                assert a.read() == b.read(), rel
        else:
            a, b = np.load(path), np.load(got[rel])
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(b, a, err_msg=rel)
    assert n_jpg == summaries["port"]["n_img"]


def test_se3_helpers_and_lms_reader(tmp_path):
    rng = np.random.default_rng(8)
    for _ in range(5):
        xyzrpy = rng.uniform(-2, 2, 6)
        np.testing.assert_array_equal(oxford_prep.build_se3_transform(xyzrpy),
                                      jax_prep.build_se3_transform(xyzrpy))
    poses = [oxford_prep.build_se3_transform(rng.uniform(-1, 1, 6))
             for _ in range(4)]
    ts, req = [0, 100, 200, 300], [10, 150, 299, 400, -5]
    for a, b in zip(oxford_prep.interpolate_poses(ts, poses, req, 120),
                    jax_prep.interpolate_poses(ts, poses, req, 120)):
        np.testing.assert_array_equal(a, b)
    scan = rng.uniform(-5, 5, (50, 3))
    scan.tofile(tmp_path / "s.bin")
    np.testing.assert_array_equal(
        oxford_prep.load_lms_scan(str(tmp_path / "s.bin")),
        jax_prep.load_lms_scan(str(tmp_path / "s.bin")))
    rel = rng.uniform(-1, 1, (6, 6))
    T = np.stack([oxford_prep.build_se3_transform(r) for r in rel])
    np.testing.assert_array_equal(oxford_prep.integrate_vo_poses(T),
                                  jax_prep.integrate_vo_poses(T))
