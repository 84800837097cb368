"""PNG writing with ``zlib`` and ``struct`` only, where the JAX package
calls ``cv2.imwrite`` (the port runs where OpenCV is not installed).

:func:`encode_png` makes an 8-bit, non-interlaced PNG of a gray (H, W) or
(H, W, 1) image or an RGB (H, W, 3) image: one IDAT chunk, every row with
filter type 0.  ``cv2.imread`` and the port's ``data/jpeg.py::read_png``
decode it to the same pixels.  Images are RGB, as in the JAX package,
which converts them to BGR for OpenCV before it writes.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of an 8-bit gray or RGB image, as bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        ctype = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"encode_png takes (H, W), (H, W, 1) or (H, W, 3) "
                         f"images, got shape {a.shape}")
    h, w = a.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"encode_png: empty image of shape {a.shape}")
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write :func:`encode_png` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
