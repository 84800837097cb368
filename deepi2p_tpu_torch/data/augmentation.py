"""Host-side augmentation (numpy), free of OpenCV.

The port's copy of the JAX package's ``data/augmentation.py``: euler
rotations and point jitter (``data/augmentation.py:14-52`` of the
reference), the uniform random pose of every loader
(``data/kitti_pc_img_pose_loader.py:136-156``), the frame conversions,
and ColorJitter with the loaders' ranges (brightness, contrast and
saturation 0.8-1.2, hue -0.1-0.1) in a random order.

The JAX package runs the colour ops through OpenCV; here each op repeats
OpenCV's arithmetic in numpy, as OpenCV computes it on an x86 host with
its default (IPP) kernels:

* brightness and contrast are ``convertScaleAbs`` on float32: one fused
  multiply-add in float32, the absolute value, round half to even,
  saturate to uint8;
* saturation is ``addWeighted`` on float32: ``fma(a, f, b * (1 - f))``;
* hue goes through ``RGB2HSV_FULL`` on uint8 (integer arithmetic with
  12-bit division tables) and ``HSV2RGB_FULL`` (integer sectors of 255
  hue steps, each value rounded to nearest; IPP rounds 92 of the 2^24
  inputs, all within 1e-4 of a half, the other way, and a table lists
  them).  Both are bitwise OpenCV's over every uint8 input.  Without the
  table one level of difference in the hue op grows to two after a
  later brightness or contrast scale (a pixel in 2 of 12 seeds of the
  jitter test); OpenCV's own float kernel (IPP off) differs from IPP in
  ~12M of the inputs.

Each op draws from the generator exactly as the JAX one does
(``tests/test_torch_port_data_augment.py`` holds every op to it).
"""
from __future__ import annotations

import numpy as np


def angles_to_rotation(angles) -> np.ndarray:
    """Rz @ Ry @ Rx for euler angles [ax, ay, az] (radians)."""
    ax, ay, az = angles
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def random_transform(rng: np.random.Generator,
                     t_amp=(0.0, 0.0, 0.0), r_amp=(0.0, 0.0, 0.0)
                     ) -> np.ndarray:
    """Uniform random 4x4 pose within the given amplitudes (a zero
    amplitude draws nothing)."""
    t = [rng.uniform(-a, a) if a else 0.0 for a in t_amp]
    ang = [rng.uniform(-a, a) if a else 0.0 for a in r_amp]
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = angles_to_rotation(ang).astype(np.float32)
    P[:3, 3] = t
    return P


def jitter(x: np.ndarray, rng: np.random.Generator,
           sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    """Per-element clipped Gaussian jitter (``data/augmentation.py:41-52``)."""
    noise = np.clip(sigma * rng.standard_normal(x.shape), -clip, clip)
    return (x + noise).astype(x.dtype)


# --------------------------------------------------------------------------
# coordinate conventions (points are (N, 3) row vectors)
# (``data/augmentation.py:55-79``, ``data/kitti_helper.py:7-22``)
# --------------------------------------------------------------------------

def cam_to_nwu(pc: np.ndarray) -> np.ndarray:
    """camera (x-right, y-down, z-forward) -> NWU (x-fwd, y-left, z-up)."""
    return np.stack([pc[:, 2], -pc[:, 0], -pc[:, 1]], axis=1)


def nwu_to_cam(pc: np.ndarray) -> np.ndarray:
    return np.stack([-pc[:, 1], -pc[:, 2], pc[:, 0]], axis=1)


def enu_to_cam(pc: np.ndarray) -> np.ndarray:
    """ENU (x-east, y-north, z-up) -> camera."""
    return np.stack([pc[:, 0], -pc[:, 2], pc[:, 1]], axis=1)


# --------------------------------------------------------------------------
# ColorJitter in OpenCV's arithmetic
# --------------------------------------------------------------------------

_F32 = np.float32
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 numbers is exact in float64."""
    return (a.astype(np.float64) * np.float64(_F32(b))
            + np.asarray(c, np.float64)).astype(np.float32)


def scale_abs(a: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """``cv2.convertScaleAbs(a, alpha=alpha, beta=beta)`` of a float32
    image, as float32 values in 0..255."""
    y = np.abs(_fma32(a, alpha, _F32(beta)))
    return np.minimum(np.rint(y), 255).astype(np.float32)


def add_weighted(a: np.ndarray, f: float, b: np.ndarray) -> np.ndarray:
    """``cv2.addWeighted(a, f, b, 1 - f, 0)`` of float32 images."""
    return _fma32(a, f, b * _F32(1.0 - f))


def _blend(a: np.ndarray, b, f: float) -> np.ndarray:
    """clip(f * a + (1 - f) * b) as the JAX package forms it: a scalar
    ``b`` through ``convertScaleAbs`` (rounded to whole levels), an image
    ``b`` through ``addWeighted``."""
    a32 = a if a.dtype == np.float32 else a.astype(np.float32)
    if np.isscalar(b) or getattr(b, "ndim", 1) == 0:
        return scale_abs(a32, f, (1.0 - f) * float(b))
    b32 = b if b.dtype == np.float32 else b.astype(np.float32)
    return np.clip(add_weighted(a32, f, b32), 0, 255)


def _adjust_brightness(img, f):
    return _blend(img, 0.0, f)


def _adjust_contrast(img, f):
    gray = img @ _GRAY
    return _blend(img, float(gray.mean()), f)


def _adjust_saturation(img, f):
    gray = (img @ _GRAY)[..., None]
    return _blend(img, np.repeat(gray, 3, axis=-1), f)


_HSV_SHIFT = 12


def _div_table(numer: int, scale: float) -> np.ndarray:
    """OpenCV's ``saturate_cast<int>((numer << 12) / (scale * i))``, 0 at
    i = 0, for i in 0..255."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.rint((numer << _HSV_SHIFT) / (scale * i))
    t[0] = 0
    return t.astype(np.int64)


_SDIV = _div_table(255, 1.0)
_HDIV_FULL = _div_table(256, 6.0)
# (b, g, r) taken from (v, p, q, t) in each hue sector
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]])


def rgb_to_hsv_full(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV_FULL)`` of uint8 RGB."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    vr = v == r
    vg = (v == g) & ~vr
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(vr, g - b, np.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV_FULL[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 256, h)
    return np.stack([np.minimum(h, 255), s, v], axis=-1).astype(np.uint8)


# (h, s, v) -> (r, g, b), each packed in 24 bits: the inputs whose value
# lies within 1e-4 of a half and which OpenCV's IPP kernel rounds the
# other way from the exact quotient
_HSV2RGB_IPP = {
    0x45d1b5: 0x58b521, 0x51a7c1: 0x4ec143, 0x51c1a7: 0x34a729, 0x76f6d3: 0x07d3a6,
    0x8080fe: 0x7ffcfe, 0x80fe80: 0x017e80, 0x8bc7ce: 0x2da2ce, 0x8bcec7: 0x269bc7,
    0x8e9ab6: 0x4890b6, 0x8eb69a: 0x2c749a, 0x8ec48f: 0x21698f, 0x94c56a: 0x18426a,
    0x9798df: 0x5a95df, 0x97df98: 0x134e98, 0x9ab5d1: 0x3d74d1, 0x9ad1b5: 0x2158b5,
    0xa2c7ce: 0x2d4bce, 0xa2cec7: 0x2644c7, 0xa4f2f6: 0x0d2df6, 0xa4f6f2: 0x0929f2,
    0xa6a7c1: 0x434ec1, 0xa6c1a7: 0x2934a7, 0xabbcd8: 0x3d39d8, 0xabcece: 0x2c28ce,
    0xabd8bc: 0x211dbc, 0xb3dbf3: 0x4f22f3, 0xb3f3db: 0x370adb, 0xc072d3: 0xa675d3,
    0xc089a4: 0x7a4ca4, 0xc0a489: 0x5f3189, 0xc476e7: 0xbe7ce7, 0xc49ab1: 0x8846b1,
    0xc4b19a: 0x712f9a, 0xc4e776: 0x4d0b76, 0xc65ea3: 0x8f67a3, 0xc6a35e: 0x4a225e,
    0xcab1f2: 0xc94af2, 0xcaf2b1: 0x8809b1, 0xcbd3f6: 0xc92af6, 0xcbf6d3: 0xa607d3,
    0xcec9fd: 0xdf36fd, 0xcefdc9: 0xab02c9, 0xd3b3de: 0xd942de, 0xd3deb3: 0xae17b3,
    0xd4dff3: 0xf11ef3, 0xd4f3df: 0xdd0adf, 0xd580fe: 0xfe7ffc, 0xd5fe80: 0x80017e,
    0xdfeff4: 0xf40fbb, 0xdff4ef: 0xef0ab6, 0xe0c7ce: 0xce2da2, 0xe0cec7: 0xc7269b,
    0xe38fc4: 0xc4569e, 0xe39ab6: 0xb64890, 0xe3b69a: 0x9a2c74, 0xe3badb: 0xdb3ba4,
    0xe3c48f: 0x8f2169, 0xe3dbba: 0xba1a83, 0xe4aedb: 0xdb46a4, 0xe4dbae: 0xae1977,
    0xe7b0e4: 0xe4479f, 0xe7c0d1: 0xd1348c, 0xe7d1c0: 0xc0237b, 0xe7e4b0: 0xb0136b,
    0xe96ac5: 0xc5739d, 0xe9c56a: 0x6a1842, 0xec6579: 0x79495e, 0xec7965: 0x65354a,
    0xec98df: 0xdf5a95, 0xecdf98: 0x98134e, 0xed748f: 0x8f4e69, 0xed8f74: 0x74334e,
    0xedb9d6: 0xd63b7c, 0xedd6b9: 0xb91e5f, 0xefb5d1: 0xd13d74, 0xefc552: 0x52132a,
    0xefc5f6: 0xf6387f, 0xefd1b5: 0xb52158, 0xeff6c5: 0xc5074e, 0xf194b0: 0xb04a6b,
    0xf1b094: 0x942e4f, 0xf1e4f1: 0xf11a60, 0xf1f1e4: 0xe40d53, 0xf4b89e: 0x9e2c49,
    0xf7c7ce: 0xce2d4b, 0xf7cec7: 0xc72644, 0xf9beda: 0xda384e, 0xf9dabe: 0xbe1c32,
    0xf9f2f6: 0xf60d2d, 0xf9f6f2: 0xf20929, 0xfba7c1: 0xc1434e, 0xfbc1a7: 0xa72934,
}
_IPP_KEYS = np.array(sorted(_HSV2RGB_IPP), np.int64)
_IPP_RGB = np.array([[(_HSV2RGB_IPP[k] >> sh) & 255 for sh in (16, 8, 0)]
                     for k in _IPP_KEYS.tolist()], np.int64)


def hsv_full_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL)`` of uint8 HSV."""
    h, s, v = (hsv[..., i].astype(np.int64) for i in range(3))
    h6 = h * 6
    sector = h6 // 255
    f = h6 - 255 * sector
    sq = 255 * 255
    tab = np.stack([v,
                    (v * (255 - s) + 127) // 255,
                    (v * (sq - s * f) + sq // 2) // sq,
                    (v * (sq - s * (255 - f)) + sq // 2) // sq], axis=-1)
    rgb = np.take_along_axis(tab, _SECTOR[sector % 6][..., ::-1], axis=-1)
    key = (h << 16) | (s << 8) | v
    pos = np.minimum(np.searchsorted(_IPP_KEYS, key), len(_IPP_KEYS) - 1)
    hit = _IPP_KEYS[pos] == key
    rgb[hit] = _IPP_RGB[pos[hit]]
    return rgb.astype(np.uint8)


def _adjust_hue(img, shift):
    """Hue rotation by ``shift`` of a full turn, in uint8 HSV."""
    u8 = np.clip(img, 0, 255).astype(np.uint8)
    hsv = rgb_to_hsv_full(u8)
    h = hsv[..., 0].astype(np.int32) + int(round(shift * 256.0))
    hsv[..., 0] = (h % 256).astype(np.uint8)
    return hsv_full_to_rgb(hsv).astype(img.dtype)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1)) -> np.ndarray:
    """Brightness, contrast, saturation and hue jitter in a random order,
    uint8 HxWx3 in and out."""
    img = img.astype(np.float32)
    ops = [
        lambda x: _adjust_brightness(x, rng.uniform(*brightness)),
        lambda x: _adjust_contrast(x, rng.uniform(*contrast)),
        lambda x: _adjust_saturation(x, rng.uniform(*saturation)),
        lambda x: _adjust_hue(x, rng.uniform(*hue)),
    ]
    for k in rng.permutation(4):
        img = ops[k](img)
    return np.clip(img, 0, 255).astype(np.uint8)
