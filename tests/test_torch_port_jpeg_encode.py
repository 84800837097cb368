"""The port's JPEG encoder (``deepi2p_tpu_torch/native/jpeg_encode.cpp``,
``data/jpeg.py::encode_jpeg`` / ``write_jpeg``) against OpenCV: its bytes
are those of ``cv2.imencode(".jpg", bgr)`` at OpenCV's defaults on flat,
gradient and noise images from 1x1 to 960x1280 (whose digests are
committed, so that a machine without OpenCV checks the same bytes), and
what it writes decodes, through the port's decoder and through
``cv2.imread``, to the same pixels."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from deepi2p_tpu_torch.data import jpeg

sys.path.insert(0, str(Path(__file__).resolve().parent / "data"
                       / "torch_port_jpeg_encode"))
import make_digests as cases  # noqa: E402

DIGESTS = cases.load_digests()


def cv2_bytes(rgb: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]))
    assert ok
    return bytes(buf)


@pytest.mark.parametrize("case", cases.CASES)
def test_bytes_are_cv2s(case):
    rgb = cases.image(case)
    got = jpeg.encode_jpeg(rgb)
    assert got == cv2_bytes(rgb)
    assert cases.digest(got) == DIGESTS[case]


def test_committed_digests_are_this_opencvs():
    """The committed digests are what the installed OpenCV writes."""
    for case in cases.CASES:
        assert cases.digest(cv2_bytes(cases.image(case))) == DIGESTS[case]


@pytest.mark.parametrize("seed", range(4))
def test_random_sizes_and_content(seed):
    """Seeded odd sizes (every edge case of the 16x16 MCU), smooth and
    saturated content, through bytes and ``write_jpeg``."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        y, x = np.mgrid[0:h, 0:w]
        smooth = 128 + 100 * np.sin(x[..., None] / rng.uniform(1, 9, 3)
                                    + y[..., None] / rng.uniform(1, 9, 3))
        rgb = np.clip(smooth + rng.normal(0, rng.uniform(0, 60), (h, w, 3)),
                      0, 255).astype(np.uint8)
        rgb[rng.random((h, w)) < 0.05] = 255
        assert jpeg.encode_jpeg(rgb) == cv2_bytes(rgb), (h, w)


@pytest.mark.parametrize("case", ["noise_33x17", "gradient_376x1241",
                                  "noise_960x1280"])
def test_written_file_decodes_to_cv2_pixels(tmp_path, case):
    rgb = cases.image(case)
    path = tmp_path / "out.jpg"
    jpeg.write_jpeg(path, rgb)
    assert path.read_bytes() == cv2_bytes(rgb)
    np.testing.assert_array_equal(jpeg.decode(path),
                                  cv2.imread(str(path))[..., ::-1])


def test_refusals():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match=r"\(4, 4\)"):
        jpeg.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="range"):
        jpeg.encode_jpeg(np.zeros((0, 4, 3), np.uint8))
