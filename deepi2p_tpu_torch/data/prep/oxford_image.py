"""Oxford RobotCar image decoding without OpenCV, counterpart of the JAX
package's ``data/prep/oxford_image.py``.

The reference delegates image decode to the external robotcar-dataset-sdk
(``data/oxford/build_dataset.py:356-378`` calls the SDK's
``load_image(path, model)``), which Bayer-demosaics the raw single-channel
PNG and undistorts it through the camera model's bilinear look-up table.
Both stages are numpy here:

- :func:`demosaic`: bilinear demosaicing for any 2x2 Bayer pattern by
  mask-normalised convolution with ``[[1,2,1],[2,4,2],[1,2,1]]`` on a
  border that repeats the edge sample (``np.pad(mode="symmetric")``, which
  is OpenCV's ``BORDER_REFLECT``).  Every sum is an integer below 2^24, so
  the f32 sums are exact in any order and the output is bitwise the JAX
  package's ``cv2.filter2D`` one.  Oxford's Bumblebee stereo camera uses
  'gbrg'; the monos use 'rggb'.
- :func:`read_distortion_lut`: parses the SDK LUT binary: flat float64,
  reshaped (2, H*W), row 0 = source x (u), row 1 = y (v) per output pixel.
- :func:`undistort`: bilinear resampling of each channel at the LUT
  coordinates in ``cv2.remap``'s own f32 arithmetic (the JAX package's
  route, ``INTER_LINEAR``, ``BORDER_CONSTANT`` 0, float maps: no 1/32
  quantisation), so the two agree bitwise.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..jpeg import read_png

BAYER_STEREO = "gbrg"
BAYER_MONO = "rggb"


def _filter_121(x: np.ndarray) -> np.ndarray:
    """The 3x3 ``[[1,2,1],[2,4,2],[1,2,1]]`` correlation of an f32 image,
    edge samples repeated at the border."""
    p = np.pad(x, 1, mode="symmetric")
    rows = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
    return rows[:-2] + 2.0 * rows[1:-1] + rows[2:]


def demosaic(raw: np.ndarray, pattern: str = BAYER_STEREO) -> np.ndarray:
    """raw (H, W) uint8/uint16 Bayer mosaic -> RGB float32 (H, W, 3).

    ``pattern`` gives the 2x2 tile reading order 'top-left top-right /
    bottom-left bottom-right', e.g. 'gbrg' =  G B / R G.
    """
    p = pattern.lower()
    if len(p) != 4 or set(p) - set("rgb"):
        raise ValueError(f"bad Bayer pattern {pattern!r}")
    raw_f = raw.astype(np.float32)
    H, W = raw_f.shape
    masks = np.zeros((3, H, W), np.float32)
    for idx, ch in enumerate(p):
        r, c = divmod(idx, 2)
        masks["rgb".index(ch)][r::2, c::2] = 1.0
    # at a missing pixel the numerator collects the available neighbours
    # (4-neighbours weight 2, diagonals weight 1) and the denominator their
    # total weight; known samples are then restored verbatim
    out = np.empty((H, W, 3), np.float32)
    for ci in range(3):
        num = _filter_121(raw_f * masks[ci])
        den = _filter_121(masks[ci])
        interp = num / np.maximum(den, np.float32(1e-6))
        out[..., ci] = np.where(masks[ci] > 0, raw_f, interp)
    return out


def read_distortion_lut(path: str, shape: Tuple[int, int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """SDK LUT binary -> (map_u (H, W), map_v (H, W)) float32 source
    coordinates per output pixel."""
    H, W = shape
    lut = np.fromfile(path, np.double)
    if lut.size != 2 * H * W:
        raise ValueError(
            f"LUT {path} has {lut.size} entries, expected 2*{H}*{W}")
    lut = lut.reshape(2, H * W)
    return (lut[0].reshape(H, W).astype(np.float32),
            lut[1].reshape(H, W).astype(np.float32))


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` on f32 arrays with one rounding, as a fused
    multiply-add: the product is exact in float64, the sum is rounded to
    odd there (an inexact sum gets an odd last bit), and the rounding of a
    round-to-odd float64 to f32 is the correct rounding of the exact
    value."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # s + err == p + c exactly
    bits = s.view(np.int64)
    even = (bits & 1) == 0
    fix = (err != 0) & even & np.isfinite(s)
    s = np.where(fix, np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def undistort(img: np.ndarray, map_u: np.ndarray,
              map_v: np.ndarray) -> np.ndarray:
    """Bilinear per-channel resample of (H, W[, C]) ``img`` at the LUT
    coordinates, bitwise ``cv2.remap(INTER_LINEAR, BORDER_CONSTANT, 0)``
    on f32 images and maps: ``fx = u - floor(u)`` in f32, a neighbour
    outside the source frame read as 0, two row interpolations
    ``p0 + fx (p1 - p0)`` and one column interpolation, each a fused
    multiply-add in f32.  The output has the maps' shape, f32."""
    src = img.astype(np.float32)
    H, W = src.shape[:2]
    # clipped so that floor() stays in int64 range; beyond W or H every
    # neighbour is outside the frame anyway
    u = np.clip(np.asarray(map_u, np.float32), -2.0, W + 1.0)
    v = np.clip(np.asarray(map_v, np.float32), -2.0, H + 1.0)
    x0f, y0f = np.floor(u), np.floor(v)
    fx, fy = u - x0f, v - y0f
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)

    def pixel(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = src[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(inside[..., None] if src.ndim == 3 else inside,
                        vals, np.float32(0))

    if src.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    p00, p01 = pixel(y0, x0), pixel(y0, x0 + 1)
    p10, p11 = pixel(y0 + 1, x0), pixel(y0 + 1, x0 + 1)
    r0 = _fma32(fx, p01 - p00, p00)
    r1 = _fma32(fx, p11 - p10, p10)
    return _fma32(fy, r1 - r0, r0)


def make_load_image(lut_path: Optional[str] = None,
                    pattern: str = BAYER_STEREO
                    ) -> Callable[[str], np.ndarray]:
    """Compose raw-PNG read + demosaic + (optional) LUT undistortion into
    the ``load_image(path) -> RGB uint8 (H, W, 3)`` contract of
    :class:`~.oxford_prep.SdkInterface`.

    A gray PNG is read as it is stored (:func:`~..jpeg.read_png` with
    ``unchanged``); a colour PNG is taken as already decoded and returned
    as RGB.  The LUT is parsed on the first image (its shape fixes H, W)
    and cached; with ``lut_path=None`` the decode is demosaic-only.
    """
    cache: dict = {}

    def load_image(path: str) -> np.ndarray:
        raw = read_png(path, unchanged=True)
        if raw.ndim == 3:          # already-decoded image: pass through
            return raw
        rgb = demosaic(raw, pattern)
        if lut_path is not None:
            if "lut" not in cache:
                cache["lut"] = read_distortion_lut(lut_path, raw.shape)
            rgb = undistort(rgb, *cache["lut"])
        return np.clip(rgb + 0.5, 0, 255).astype(np.uint8)

    return load_image
