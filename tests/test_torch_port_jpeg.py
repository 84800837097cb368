"""The port's image readers (``deepi2p_tpu_torch/data/jpeg.py``, the native
``jpeg.cpp``) against OpenCV: JPEG decodes bitwise ``cv2.imread`` at full
size and ``cv2.IMREAD_REDUCED_COLOR_2/4/8``, on the committed fixtures
(whose ``cv2`` digests one test recomputes) and on JPEGs written here with
seeded content across qualities, samplings and odd sizes; PNGs bitwise,
each row filter; the refusals name the file and the feature; and
``load_image`` / ``read_rgb`` equal the JAX package's."""
import hashlib
import json
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest

from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import base as jax_base
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import base, jpeg

FIXTURES = Path(__file__).resolve().parent / "data" / "torch_port_jpeg"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
FLAGS = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
         4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}
SAMPLINGS = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def sha(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def cv2_rgb(data: bytes, denom: int = 1):
    return cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[denom])[..., ::-1]


def picture(h, w, seed):
    """Seeded content with edges, gradients and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x * 255 / max(w, 1), y * 255 / max(h, 1),
                    128 + 100 * np.sin((x + y) / 7)], -1)
    for _ in range(6):
        x0, x1 = np.sort(rng.integers(0, w + 1, 2))
        y0, y1 = np.sort(rng.integers(0, h + 1, 2))
        img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img, *params, ext=".jpg"):
    """``img`` (RGB, RGBA or gray) written by ``cv2.imencode``."""
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    ok, enc = cv2.imencode(ext, img, list(params))
    assert ok
    return enc.tobytes()


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests_are_cv2s(name):
    """The committed digests are what cv2 decodes from the fixture."""
    for denom, (h, w, digest) in DIGESTS[name].items():
        rgb = cv2.imread(str(FIXTURES / name), FLAGS[int(denom)])[..., ::-1]
        assert rgb.shape == (h, w, 3) and sha(rgb) == digest, (name, denom)


@pytest.mark.parametrize("denom", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_digest(name, denom):
    h, w, digest = DIGESTS[name][str(denom)]
    rgb = jpeg.decode(FIXTURES / name, denom)
    assert rgb.shape == (h, w, 3) and rgb.dtype == np.uint8
    assert sha(rgb) == digest


def test_fixtures_cover_the_datasets():
    sizes = {tuple(v["1"][:2]) for v in DIGESTS.values()}
    assert {(960, 1280), (900, 1600), (376, 1241)} <= sizes
    # the Oxford frame at half size, as config.oxford decodes it
    assert DIGESTS["oxford_1280x960_420_q95.jpg"]["2"][:2] == [480, 640]
    # the odd width decodes to ceil(1241 / d)
    assert [DIGESTS["kitti_1241x376_420_q95.jpg"][str(d)][1]
            for d in (1, 2, 4, 8)] == [1241, 621, 311, 156]


# --------------------------------------------------------------------------
# generated JPEGs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_generated_bitwise(quality, sampling):
    seed = quality * 10 + len(sampling)
    for h, w in [(48, 64), (37, 53), (61, 99), (17, 9), (3, 5), (1, 1)]:
        data = encode(picture(h, w, seed), cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling])
        for denom in FLAGS:
            ref = cv2_rgb(data, denom)
            got = jpeg.decode(data, denom)
            assert got.shape == ref.shape, (h, w, denom)
            assert np.array_equal(got, ref), (h, w, denom)


@pytest.mark.parametrize("interval", [0, 1, 3, 7])
def test_grayscale_and_restart_intervals(interval):
    for h, w in [(40, 56), (33, 47)]:
        img = picture(h, w, interval)
        for src in (img, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)):
            data = encode(src, cv2.IMWRITE_JPEG_QUALITY, 90,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
            assert (b"\xff\xdd" in data) == (interval > 0)
            for denom in FLAGS:
                assert np.array_equal(jpeg.decode(data, denom),
                                      cv2_rgb(data, denom)), (h, w, denom)


def test_extremes_bitwise():
    """Saturated and noise-only content (large coefficients, clamping in
    the IDCT's range limit and in the colour conversion)."""
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (40, 72, 3), dtype=np.uint8),
                (rng.integers(0, 2, (40, 72, 3)) * 255).astype(np.uint8)):
        for q in (10, 100):
            data = encode(img, cv2.IMWRITE_JPEG_QUALITY, q)
            for denom in FLAGS:
                assert np.array_equal(jpeg.decode(data, denom),
                                      cv2_rgb(data, denom))


def test_threads_decode_alike():
    """The decode holds no shared state: threads give the same bits."""
    data = (FIXTURES / "kitti_1241x376_420_q95.jpg").read_bytes()
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda d: jpeg.decode(data, d), [2] * 8))
    assert all(np.array_equal(o, outs[0]) for o in outs)
    assert sha(outs[0]) == DIGESTS["kitti_1241x376_420_q95.jpg"]["2"][2]


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def exif_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an EXIF APP1 segment whose IFD0 holds only the
    orientation tag, inserted after SOI."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + data[2:]


def patch_sof(data: bytes, *, marker=None, precision=None, ncomp=None):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    if ncomp is not None:
        out[i + 9] = ncomp
    return bytes(out)


def test_exif_orientation_is_refused(tmp_path):
    img = picture(24, 40, 0)
    data = encode(img)
    rotated = exif_orientation(data, 6)
    # cv2 applies the tag (a 90 degree turn), so decoding the pixels as
    # they lie would differ from it
    assert cv2_rgb(rotated).shape == (40, 24, 3)
    path = tmp_path / "turned.jpg"
    path.write_bytes(rotated)
    with pytest.raises(ValueError, match=r"turned\.jpg: EXIF orientation 6"):
        jpeg.decode(path)
    # orientation 1 is the identity: decoded as cv2 does
    upright = exif_orientation(data, 1)
    assert np.array_equal(jpeg.decode(upright), cv2_rgb(upright))


@pytest.mark.parametrize("case,match", [
    ("progressive", "progressive JPEG"),
    ("arithmetic", "arithmetic-coded JPEG"),
    ("lossless", "lossless JPEG"),
    ("12bit", "12-bit samples"),
    ("cmyk", "CMYK"),
    ("png_palette", "palette"),
    ("png_16bit", "16-bit PNG"),
    ("png_filter5", r"unknown PNG filter type 5"),
    ("neither", "neither a JPEG nor a PNG"),
])
def test_refusals_name_file_and_feature(tmp_path, case, match):
    img = picture(16, 24, 1)
    data = {
        "progressive": lambda: encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "arithmetic": lambda: patch_sof(encode(img), marker=0xC9),
        "lossless": lambda: patch_sof(encode(img), marker=0xC3),
        "12bit": lambda: patch_sof(encode(img), precision=12),
        "cmyk": lambda: patch_sof(encode(img), ncomp=4),
        "png_palette": lambda: png_bytes(img[..., 0], ctype=3),
        "png_16bit": lambda: png_bytes(img[..., 0], depth=16),
        "png_filter5": lambda: png_bytes(img[..., 0], filters=(0, 5)),
        "neither": lambda: b"GIF89a" + bytes(32),
    }[case]()
    path = tmp_path / f"{case}.img"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{case}.img: .*{match}"):
        jpeg.read_image(path)


def patch_dht_bits(data: bytes, bits) -> bytes:
    """``data`` with the first Huffman table's 16 code-length counts
    replaced by ``bits`` (its values then run on into the bytes after)."""
    i = data.index(b"\xff\xc4") + 5
    return data[:i] + bytes(bits) + data[i + 16:]


@pytest.mark.parametrize("bits", [
    [2] + [0] * 15,                # the second 1-bit code is all ones
    [3] + [0] * 15,                # a third 1-bit code: 2 needs 2 bits
    [200] + [0] * 15,              # codes far past 1 bit
    [0, 4, 1] + [0] * 13,          # 2-bit codes fill the length
    [0] * 6 + [127, 0, 5] + [0] * 7,   # the fifth 9-bit code is 512
])
def test_corrupt_huffman_table_is_refused(tmp_path, bits):
    """Code-length counts that break the prefix code are refused before
    they index the decoder's tables (libjpeg refuses them too: cv2 reads
    nothing)."""
    data = patch_dht_bits(encode(picture(16, 24, 2)), bits)
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    path = tmp_path / "huff.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=r"huff\.jpg: corrupt Huffman table"):
        jpeg.decode(path)
    with pytest.raises(ValueError, match="corrupt Huffman table"):
        jpeg.decode(data, 2)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

def png_bytes(pix, *, ctype=None, depth=8, filters=(0,)):
    """A PNG written by hand with the given row filter types, in turn."""
    pix = np.asarray(pix, np.uint8)
    h, w = pix.shape[:2]
    ch = 1 if pix.ndim == 2 else pix.shape[2]
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = pix.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    out = jpeg.PNG_SIGNATURE + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if ctype == 3:
        out += chunk(b"PLTE", bytes(range(256)) * 3)
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + \
        chunk(b"IEND", b"")


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filters_bitwise(channels):
    rng = np.random.default_rng(channels)
    pix = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    pix = pix[..., 0] if channels == 1 else pix
    for filters in [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)]:
        data = png_bytes(pix, filters=filters)
        assert np.array_equal(jpeg.read_png(data), cv2_rgb(data)), filters


def test_png_from_cv2_bitwise(tmp_path):
    img = picture(45, 67, 5)
    for src in (img, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY),
                np.dstack([img, img[..., :1]])):
        for level in (0, 9):
            data = encode(src, cv2.IMWRITE_PNG_COMPRESSION, level, ext=".png")
            path = tmp_path / "x.png"
            path.write_bytes(data)
            assert np.array_equal(jpeg.read_png(path), cv2_rgb(data))
            assert np.array_equal(base.read_rgb(str(path)), cv2_rgb(data))


# --------------------------------------------------------------------------
# the loaders' entry points against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["oxford_1280x960_420_q95.jpg",
                                  "nuscenes_1600x900_420_q90.jpg",
                                  "kitti_1241x376_420_q95.jpg",
                                  "gray_q95.jpg"])
@pytest.mark.parametrize("preset,over", [
    ("oxford", {}),                                   # 1/2 in the DCT
    ("oxford", {"img_scale": 0.25}),                  # 1/4
    ("oxford", {"img_scale": 0.125}),                 # 1/8
    ("oxford", {"crop_original_top_rows": 3}),        # rows not integral
    ("nuscenes", {}),                                 # scale 0.2: full
])
def test_load_image_matches_jax(name, preset, over):
    path = str(FIXTURES / name)
    cfg = getattr(config, preset)(**over)
    jcfg = getattr(jax_config, preset)(**over)
    got, pre = base.load_image(path, cfg)
    ref, jpre = jax_base.load_image(path, jcfg)
    assert pre == jpre
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_read_rgb_matches_cv2(name):
    path = str(FIXTURES / name)
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    assert np.array_equal(base.read_rgb(path), ref)
