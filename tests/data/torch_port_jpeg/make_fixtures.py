"""Writes the JPEG fixtures of ``tests/test_torch_port_jpeg.py`` with
``cv2.imwrite`` and the SHA-256 of what ``cv2.imread`` decodes from each
(RGB bytes) at full, half, quarter and eighth size, into ``digests.json``.

    python tests/data/torch_port_jpeg/make_fixtures.py

The content is a seeded street-like picture (sky, facades, road, fine
texture), so the files hold the coefficient statistics of a camera frame.
"""
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
FLAGS = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
         4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}
S420 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
S444 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444
# name -> (height, width, imwrite parameters, grayscale)
FIXTURES = {
    # what data/prep/oxford_prep.py writes: imwrite's defaults (q95, 4:2:0)
    "oxford_1280x960_420_q95.jpg": (960, 1280, [], False),
    "nuscenes_1600x900_420_q90.jpg": (
        900, 1600, [cv2.IMWRITE_JPEG_QUALITY, 90], False),
    "kitti_1241x376_420_q95.jpg": (376, 1241, [], False),
    "s444_q85.jpg": (240, 320, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S444],
                     False),
    "restart_q75.jpg": (245, 333, [cv2.IMWRITE_JPEG_QUALITY, 75,
                                   cv2.IMWRITE_JPEG_RST_INTERVAL, 5], False),
    "gray_q95.jpg": (243, 317, [], True),
}


def street(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded (h, w, 3) uint8 RGB street-like picture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    horizon = 0.45 * h
    sky = np.array([110, 150, 220], np.float32)
    img[:] = sky * (0.6 + 0.4 * y[..., None] / h)
    road = y > horizon
    img[road] = np.array([90, 90, 95], np.float32)
    for _ in range(40):     # facades and cars
        x0, x1 = np.sort(rng.integers(0, w, 2))
        y1 = rng.integers(int(horizon), h)
        y0 = rng.integers(0, y1)
        img[y0:y1, x0:x1] = rng.uniform(30, 230, 3)
    img += 18 * np.sin(x[..., None] / rng.uniform(2, 9, 3))  # fine stripes
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def cv2_digests(path: Path) -> dict:
    """{scale denominator: [height, width, sha256 of cv2's RGB]}."""
    out = {}
    for d, flag in FLAGS.items():
        rgb = cv2.imread(str(path), flag)[..., ::-1]
        out[str(d)] = [rgb.shape[0], rgb.shape[1], digest(rgb)]
    return out


def main():
    table = {}
    for i, (name, (h, w, params, gray)) in enumerate(FIXTURES.items()):
        img = cv2.cvtColor(street(h, w, i), cv2.COLOR_RGB2BGR)
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        cv2.imwrite(str(HERE / name), img, params)
        table[name] = cv2_digests(HERE / name)
    (HERE / "digests.json").write_text(json.dumps(table, indent=1) + "\n")


if __name__ == "__main__":
    main()
