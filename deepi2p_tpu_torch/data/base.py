"""Loader machinery shared by the datasets (numpy): camera math, the
image pipeline, point resampling and node sampling.

The port's copy of the JAX package's ``data/base.py``:

* intrinsics scaling and cropping (``data/kitti_helper.py:193-203``);
* the crop -> scale -> random (train) or centre crop image pipeline of
  every loader (``data/kitti_pc_img_pose_loader.py:329-349``); the scale
  is OpenCV's ``INTER_LINEAR`` resize repeated in numpy
  (:func:`resize_linear`) and the images are decoded by the port's own
  JPEG and PNG readers (:mod:`.jpeg`), so no OpenCV is needed;
* resampling to N points with a voxel pre-downsample when the cloud holds
  more than 2N (``data/kitti_pc_img_pose_loader.py:298-306``);
* FPS nodes from a random 8x subset
  (``data/kitti_pc_img_pose_loader.py:416-423``), by the native core
  unless the caller asks for numpy.

Every sample is a dict of fixed-shape float32 arrays, points (N, 3);
:func:`collate` stacks them into a batch.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import Config
from ..ops.sampling import (farthest_point_sample_np, random_resample_np,
                            voxel_downsample_np)
from . import jpeg
from .augmentation import color_jitter, jitter


# --------------------------------------------------------------------------
# camera intrinsics
# --------------------------------------------------------------------------

def scale_K(K: np.ndarray, s: float) -> np.ndarray:
    Ks = K * s
    Ks[2, 2] = 1.0
    return Ks


def crop_K(K: np.ndarray, dx: float, dy: float) -> np.ndarray:
    Kc = K.copy()
    Kc[0, 2] -= dx
    Kc[1, 2] -= dy
    return Kc


# --------------------------------------------------------------------------
# images
# --------------------------------------------------------------------------

# img_scale -> the decoder's scale denominator (cv2.IMREAD_REDUCED_COLOR_2,
# _4 and _8 in the JAX package)
_REDUCED_DECODE = {0.5: 2, 0.25: 4, 0.125: 8}


def read_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG as uint8 RGB at full resolution, bitwise what
    ``cv2.imread`` gives (reversed to RGB); no OpenCV is needed
    (:mod:`.jpeg`)."""
    return jpeg.read_image(path)


def load_image(path: str, cfg: Config):
    """Decode a JPEG, at reduced resolution when ``img_scale`` is a power
    of 1/2 and the crop rows stay integral (the decoder then scales in the
    DCT domain, as ``cv2.IMREAD_REDUCED_COLOR_2/4/8`` do).  Returns (uint8
    RGB image, pre_scaled)."""
    s = cfg.img_scale
    if (s in _REDUCED_DECODE
            and float(cfg.crop_original_top_rows * s).is_integer()
            and float(cfg.crop_original_bottom_rows * s).is_integer()):
        return jpeg.read_image(path, _REDUCED_DECODE[s]), True
    return read_rgb(path), False


_COEF_BITS = 11        # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(n_src: int, n_dst: int, clamp_weight: bool):
    """OpenCV's half-pixel bilinear taps along one axis: the two source
    indices, clamped to the image, and the float32 weight of the second.
    Along x a tap outside the image moves the weight onto the edge pixel
    (``clamp_weight``); along y both taps land on the edge row and keep
    their weights, as OpenCV's row buffers do."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(np.float32)
    if clamp_weight:
        f[i < 0] = 0
        f[i >= n_src - 1] = 0
        i = np.clip(i, 0, n_src - 1)
    return np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), f


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)``
    of an (H, W, C) uint8 or float32 image, in OpenCV's arithmetic.

    uint8 runs OpenCV's fixed point: 11-bit weights, the horizontal pass
    in integers, the vertical pass as its SIMD code forms it (each row
    shifted right by 4, multiplied high by the weight, the sum rounded by
    2 bits).  float32 runs the two passes in float32, as OpenCV's own
    kernels do (its IPP kernels, the default on x86, round the weights
    differently, by up to ~1e-4 of the value).  An exact halving in both
    axes is OpenCV's area average, as there.
    """
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_linear: uint8 or float32 image, got "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    if img.dtype == np.float32 and (h, w) == (2 * height, 2 * width):
        return ((img[0::2, 0::2] + img[0::2, 1::2]) + img[1::2, 0::2]
                + img[1::2, 1::2]) * np.float32(0.25)
    x0, x1, fx = _linear_taps(w, width, clamp_weight=True)
    y0, y1, fy = _linear_taps(h, height, clamp_weight=False)
    one = np.float32(1)
    if img.dtype == np.float32:
        rows = img[:, x0] * (one - fx)[:, None] + img[:, x1] * fx[:, None]
        return (rows[y0] * (one - fy)[:, None, None]
                + rows[y1] * fy[:, None, None])

    def fixed(weight, *shape):
        return np.rint(weight * _COEF_SCALE).astype(np.int64).reshape(
            -1, *shape)

    src = img.astype(np.int64)
    rows = (src[:, x0] * fixed(one - fx, 1) + src[:, x1] * fixed(fx, 1))
    out = (((fixed(one - fy, 1, 1) * (rows[y0] >> 4)) >> 16)
           + ((fixed(fy, 1, 1) * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def process_image(img: np.ndarray, K: np.ndarray, cfg: Config, *,
                  train: bool, rng: np.random.Generator,
                  pre_scaled: bool = False):
    """top/bottom crop -> scale -> random (train) or centre crop to
    (img_H, img_W).  ``pre_scaled`` means the decoder already applied
    ``img_scale`` (:func:`load_image`); the crop rows are then taken in
    scaled pixels, the same window.  Returns (float32 HxWx3 image in
    0..255, K adjusted)."""
    s = cfg.img_scale
    if pre_scaled:
        top = int(round(cfg.crop_original_top_rows * s))
        bot = int(round(cfg.crop_original_bottom_rows * s))
        if top:
            img = img[top:]
        if bot:
            img = img[:img.shape[0] - bot]
        K = scale_K(K, s)
        K = crop_K(K, 0, top)
    else:
        if cfg.crop_original_top_rows:
            img = img[cfg.crop_original_top_rows:]
            K = crop_K(K, 0, cfg.crop_original_top_rows)
        if cfg.crop_original_bottom_rows:
            img = img[:img.shape[0] - cfg.crop_original_bottom_rows]
        img = resize_linear(img, int(round(img.shape[1] * s)),
                            int(round(img.shape[0] * s)))
        K = scale_K(K, s)
    if train:
        dx = rng.integers(0, img.shape[1] - cfg.img_W + 1)
        dy = rng.integers(0, img.shape[0] - cfg.img_H + 1)
    else:
        dx = (img.shape[1] - cfg.img_W) // 2
        dy = (img.shape[0] - cfg.img_H) // 2
    img = img[dy:dy + cfg.img_H, dx:dx + cfg.img_W]
    K = crop_K(K, dx, dy)
    return img.astype(np.float32), K.astype(np.float32)


# --------------------------------------------------------------------------
# point cloud assembly
# --------------------------------------------------------------------------

def resample_points(pc: np.ndarray, extras: List[np.ndarray], n: int,
                    rng: np.random.Generator, voxel: float):
    """(N0, 3) -> exactly n points; voxel pre-downsample when N0 > 2n."""
    if pc.shape[0] > 2 * n:
        if extras:
            extra_cat = np.concatenate(extras, axis=1)
            pc, extra_cat = voxel_downsample_np(pc, voxel, extra_cat)
            splits = np.cumsum([e.shape[1] for e in extras])[:-1]
            extras = list(np.split(extra_cat, splits, axis=1))
        else:
            pc = voxel_downsample_np(pc, voxel)
    idx = random_resample_np(pc.shape[0], n, rng)
    return pc[idx], [e[idx] for e in extras]


def sample_nodes(pc: np.ndarray, num: int, rng: np.random.Generator,
                 oversample: int = 8, native: bool = True) -> np.ndarray:
    """FPS over a random ``oversample * num`` subset
    (``data/kitti_pc_img_pose_loader.py:416-423``): by the native core
    (its first point seeded by one draw of ``rng``) or, with
    ``native=False``, by numpy (its first point drawn from ``rng``)."""
    pool = min(pc.shape[0], oversample * num)
    sub = pc[rng.choice(pc.shape[0], pool, replace=False)]
    if native:
        from . import native as core
        idx = core.fps(sub, num, seed=int(rng.integers(2 ** 63)))
        return sub[idx].astype(np.float32)
    nodes, _ = farthest_point_sample_np(sub, num, rng)
    return nodes.astype(np.float32)


def assemble_sample(cfg: Config, rng: np.random.Generator, *,
                    pc: np.ndarray, intensity: np.ndarray, sn: np.ndarray,
                    img: np.ndarray, K: np.ndarray, P: np.ndarray,
                    t_ij: np.ndarray, native: bool = True
                    ) -> Dict[str, np.ndarray]:
    """Finalize a sample: FPS nodes, float32 and fixed shapes."""
    node_a = sample_nodes(pc, cfg.node_a_num, rng, native=native)
    node_b = sample_nodes(pc, cfg.node_b_num, rng, native=native)
    return dict(
        pc=pc.astype(np.float32),
        intensity=intensity.astype(np.float32).reshape(-1, 1),
        sn=sn.astype(np.float32),
        node_a=node_a, node_b=node_b,
        P=P[:3, :4].astype(np.float32),
        img=img.astype(np.float32),
        K=K.astype(np.float32),
        t_ij=t_ij.astype(np.float32),
    )


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def augment_points(pc, intensity, sn, rng, *, jitter_sn: bool):
    """Gaussian jitter on points, and on normals (KITTI) or intensity
    (Oxford) (``kitti_pc_img_pose_loader.py:108-118``,
    ``oxford_pc_img_pose_loader.py:116-127``)."""
    pc = jitter(pc, rng)
    if jitter_sn:
        sn = jitter(sn, rng)
    else:
        intensity = jitter(intensity, rng)
    return pc, intensity, sn


def maybe_color_jitter(img: np.ndarray, rng: np.random.Generator,
                       p: float = 1.0) -> np.ndarray:
    if rng.random() < p:
        return color_jitter(img.astype(np.uint8), rng).astype(np.float32)
    return img


def crop_pc_with_img(pc: np.ndarray, extras: List[np.ndarray],
                     img_shape, K: np.ndarray):
    """Keep the points whose projection lands inside the image
    (``data/kitti_helper.py:166-190``); pc (N, 3) in camera coords."""
    H, W = img_shape[:2]
    proj = pc @ K.T
    uv = np.round(proj[:, :2] / proj[:, 2:3])
    keep = ((uv[:, 0] >= 0) & (uv[:, 0] <= W - 1) &
            (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1))
    return pc[keep], [e[keep] for e in extras]
