"""The images of ``tests/test_torch_port_jpeg_encode.py`` and the SHA-256
of the bytes ``cv2.imencode(".jpg", bgr)`` gives for each at OpenCV's
defaults, written into ``digests.json``:

    python tests/data/torch_port_jpeg_encode/make_digests.py

The images are made by integer arithmetic alone (no random generator
whose stream could change between numpy versions), so a machine without
OpenCV makes the same pixels and holds the port's encoder to these
digests (``chip_smoke.py``'s ``prep`` phase).
"""
import hashlib
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SIZES = ((1, 1), (7, 9), (16, 16), (33, 17), (376, 1241), (960, 1280))
KINDS = ("flat", "gradient", "noise")
CASES = tuple(f"{kind}_{h}x{w}" for h, w in SIZES for kind in KINDS)


def image(case: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB image of a case name ``<kind>_<H>x<W>``."""
    kind, size = case.split("_")
    h, w = (int(v) for v in size.split("x"))
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    if kind == "flat":
        return np.broadcast_to(np.array([37, 200, 120], np.uint8),
                               (h, w, 3)).copy()
    if kind == "gradient":
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) * 127 // max(h + w - 2, 1) + 64],
                        axis=-1).astype(np.uint8)
    if kind == "noise":
        # a 32-bit integer hash of (y, x, channel)
        c = np.arange(3, dtype=np.int64)
        v = ((y[..., None] * 73856093) ^ (x[..., None] * 19349663)
             ^ (c * 83492791)) & 0xFFFFFFFF
        v = ((v ^ (v >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
        v = ((v ^ (v >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
        return ((v ^ (v >> 16)) & 0xFF).astype(np.uint8)
    raise ValueError(f"unknown case {case!r}")


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def load_digests() -> dict:
    return json.loads((HERE / "digests.json").read_text())


def main():
    import cv2
    out = {}
    for case in CASES:
        ok, buf = cv2.imencode(".jpg", image(case)[..., ::-1].copy())
        assert ok, case
        out[case] = digest(bytes(buf))
    out["opencv"] = cv2.__version__
    (HERE / "digests.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
