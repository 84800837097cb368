"""Image decoding without OpenCV: JPEG through the port's native decoder,
PNG through ``zlib`` and the native row unfilter.

* :func:`decode` binds ``native/jpeg.cpp`` (built with the native core,
  :mod:`.native`), a baseline JPEG decoder that repeats libjpeg-turbo's
  integer arithmetic, so that its RGB output is bitwise what
  ``cv2.imread`` gives (BGR, reversed), and at ``scale_denom`` 2, 4 or 8
  what ``cv2.IMREAD_REDUCED_COLOR_2/4/8`` give: the decoder then scales in
  the DCT domain.  Progressive or arithmetic-coded files, 12-bit samples,
  CMYK and RGB-coded files, and an EXIF orientation other than 1 (which
  OpenCV would apply) raise a ``ValueError`` that names the file and the
  feature.
* :func:`read_png` reads 8-bit, non-interlaced gray, gray+alpha, RGB and
  RGBA PNGs (alpha dropped, gray replicated, as ``cv2.imread`` with
  ``IMREAD_COLOR`` does); PNG is lossless, so the pixels are the file's.
  ``zlib`` inflates the image data, and ``jpeg.cpp``'s ``png_unfilter``
  undoes the row filters (a byte-serial loop over each row).
* :func:`read_image` picks by the file's signature.
* :func:`encode_jpeg` and :func:`write_jpeg` bind
  ``native/jpeg_encode.cpp``, a baseline encoder that repeats
  libjpeg-turbo's arithmetic at ``cv2.imwrite``'s defaults (quality 95,
  4:2:0, standard Huffman tables), so that its bytes are those of
  ``cv2.imwrite(path, rgb[..., ::-1])``.

The decode releases the GIL (ctypes), so loader threads decode in
parallel.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Union

import numpy as np

from . import native

Source = Union[bytes, bytearray, memoryview, str, os.PathLike]

JPEG_SIGNATURE = b"\xff\xd8"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
SCALE_DENOMS = (1, 2, 4, 8)
_ERR_LEN = 256


def _read(src: Source):
    """(bytes, name for messages)."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


def decode(src: Source, scale_denom: int = 1) -> np.ndarray:
    """A baseline JPEG (bytes or a path) as (H, W, 3) uint8 RGB, at
    ``1 / scale_denom`` of its size (``ceil`` on each axis)."""
    data, name = _read(src)
    return _decode(data, name, scale_denom)


def _decode(data: bytes, name: str, scale_denom: int) -> np.ndarray:
    if scale_denom not in SCALE_DENOMS:
        raise ValueError(f"{name}: scale_denom must be one of "
                         f"{SCALE_DENOMS}, got {scale_denom}")
    lib = native.load_library()
    buf = np.frombuffer(data, np.uint8)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int64(), ctypes.c_int64()
    if lib.jpeg_dims(ptr, buf.size, scale_denom, ctypes.byref(h),
                     ctypes.byref(w), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(ptr, buf.size, scale_denom,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       h.value, w.value, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"image data holds {rows.size} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if native.load_library().png_unfilter(
            rows.ctypes.data_as(u8p), h, stride, bpp,
            out.ctypes.data_as(u8p), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def read_png(src: Source, unchanged: bool = False) -> np.ndarray:
    """An 8-bit non-interlaced PNG (bytes or a path) as (H, W, 3) uint8
    RGB; with ``unchanged``, a gray PNG as (H, W) uint8, as
    ``cv2.IMREAD_UNCHANGED`` gives it (other kinds as without)."""
    data, name = _read(src)
    return _png(data, name, unchanged)


def _png(data: bytes, name: str, unchanged: bool = False) -> np.ndarray:
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, ihdr, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} (palette) is "
                         "not supported")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    ch = _PNG_CHANNELS[ctype]
    try:
        pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    except (zlib.error, ValueError) as e:
        raise ValueError(f"{name}: corrupt PNG data ({e})") from e
    pix = pix.reshape(h, w, ch)
    if unchanged and ch == 1:
        return pix[..., 0]
    if ch <= 2:
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def read_image(src: Source, scale_denom: int = 1) -> np.ndarray:
    """A JPEG or PNG as (H, W, 3) uint8 RGB; a PNG only at full size."""
    data, name = _read(src)
    if data.startswith(PNG_SIGNATURE):
        if scale_denom != 1:
            raise ValueError(f"{name}: a PNG is read at full size only "
                             f"(scale_denom {scale_denom})")
        return _png(data, name)
    if not data.startswith(JPEG_SIGNATURE):
        raise ValueError(f"{name}: neither a JPEG nor a PNG file")
    return _decode(data, name, scale_denom)


# --------------------------------------------------------------------------
# JPEG encoding
# --------------------------------------------------------------------------

def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB as the bytes of ``cv2.imencode(".jpg", bgr)``
    at OpenCV's defaults."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg: expected (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    lib = native.load_library()
    out = np.empty(lib.jpeg_encode_bound(h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.jpeg_encode(rgb.ctypes.data_as(u8p), h, w,
                        out.ctypes.data_as(u8p), out.size, err, _ERR_LEN)
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    return out[:n].tobytes()


def write_jpeg(path: Union[str, os.PathLike], rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a JPEG, the bytes of
    ``cv2.imwrite(path, rgb[..., ::-1])``."""
    data = encode_jpeg(rgb)
    with open(path, "wb") as f:
        f.write(data)
