"""Structured label-corruption models for solver quality evaluation, a
numpy copy of the JAX package's ``register/noise.py``: the same
``np.random.Generator`` state gives the same flips.

A real classifier's errors are spatially clustered, not i.i.d.: whole
occluded structures are mislabelled together, and uncertainty
concentrates along the frustum boundary.  These models make such errors,
so the solver's knobs (24 LM iterations against the reference's <= 500,
``evaluation/registration_lsq.py:177``; the probe stride; 8 survivors)
are held to adversarial noise, not friendly noise.  Each function works
on one sample, on the host.
"""
from __future__ import annotations

import numpy as np


def flip_iid(rng: np.random.Generator, labels: np.ndarray,
             rate: float) -> np.ndarray:
    """Symmetric i.i.d. flips (the friendly model)."""
    flip = rng.uniform(size=labels.shape) < rate
    return np.where(flip, 1 - labels, labels)


def flip_sectors(rng: np.random.Generator, pc: np.ndarray,
                 labels: np.ndarray, *, n_sectors: int = 32,
                 n_flipped: int = 3) -> np.ndarray:
    """Flip ALL labels inside ``n_flipped`` random azimuthal sectors.

    Models whole-structure errors (an occluded building classified
    wholesale the wrong way): errors are perfectly correlated within a
    contiguous angular wedge of the cloud.  With n_sectors=32 and
    n_flipped=3 the marginal flip rate is ~9%, comparable to the 10%
    i.i.d. row, but concentrated instead of diffuse.
    """
    az = np.arctan2(pc[:, 0], pc[:, 2])                 # (-pi, pi]
    sector = ((az + np.pi) / (2 * np.pi) * n_sectors).astype(int) \
        % n_sectors
    bad = rng.choice(n_sectors, size=n_flipped, replace=False)
    flip = np.isin(sector, bad)
    return np.where(flip, 1 - labels, labels)


def flip_border_band(rng: np.random.Generator, labels: np.ndarray,
                     pc: np.ndarray, P: np.ndarray, K: np.ndarray,
                     H: int, W: int, *, band_px: float = 40.0,
                     rate: float = 0.5) -> np.ndarray:
    """Flip labels of points whose GT projection lies within ``band_px``
    of the frustum boundary (either side), each with probability
    ``rate``.

    Models classifier uncertainty at the frustum edge: exactly the points
    whose membership is hardest to predict — and the ones the solver's
    cost gradient relies on — carry the errors.
    """
    R, t = P[:3, :3], P[:3, 3]
    cam = pc @ R.T + t
    z = cam[:, 2]
    front = z > 0.1
    zs = np.where(front, z, 1.0)
    px = K[0, 0] * cam[:, 0] / zs + K[0, 2]
    py = K[1, 1] * cam[:, 1] / zs + K[1, 2]
    # signed distance to the image rectangle (negative = inside)
    dx = np.maximum(-px, px - (W - 1))
    dy = np.maximum(-py, py - (H - 1))
    d = np.where((dx <= 0) & (dy <= 0), np.maximum(dx, dy),
                 np.hypot(np.maximum(dx, 0), np.maximum(dy, 0)))
    in_band = front & (np.abs(d) < band_px)
    flip = in_band & (rng.uniform(size=labels.shape) < rate)
    return np.where(flip, 1 - labels, labels)


def drop_insiders(rng: np.random.Generator, labels: np.ndarray, *,
                  miss_rate: float, fp_rate: float = 0.0) -> np.ndarray:
    """Asymmetric recall-limited corruption: each TRUE insider is missed
    (labelled outside) with ``miss_rate``; each true outsider becomes a
    false positive with ``fp_rate``.

    This is the failure mode of an actual trained classifier (inside
    recall ~0.4 at precision ~0.5 while accuracy read 0.83): unlike
    symmetric flips, the error mass concentrates on false negatives,
    whose outside-residuals actively repel the frustum.
    """
    miss = (labels == 1) & (rng.uniform(size=labels.shape) < miss_rate)
    fp = (labels == 0) & (rng.uniform(size=labels.shape) < fp_rate)
    out = np.where(miss, 0, labels)
    return np.where(fp, 1, out)


def error_rate(labels: np.ndarray, corrupted: np.ndarray) -> float:
    return float(np.mean(labels != corrupted))
