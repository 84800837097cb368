"""Visual diagnostics without OpenCV or matplotlib, counterpart of the JAX
package's ``utils/vis.py`` (reference ``util/vis_tools.py``).

:func:`grid`, :func:`classification_overlay` and
:func:`registration_overlay` give arrays bitwise equal to the JAX
package's, which draws with ``cv2``: a grid line is a 1-px axis-aligned
``cv2.line`` (both ends drawn, clipped to the canvas), a point a filled
``cv2.circle`` of radius 0 to 3 (its stencils in :data:`DISC_HALF_WIDTHS`;
a radius outside them raises ``ValueError``).  Points are drawn in index
order, so where stencils overlap the later point wins; the vectorised
draw takes, per pixel, the highest index whose stencil covers it.  Pixel
centres are ``int(round(x))``, which rounds half to even (``np.rint``).

The JAX package's ``plot_pc`` and ``fig_to_np`` are matplotlib API.  Here
:func:`plot_pc` returns the image of an orthographic scatter drawn by this
module's own small rasterizer (:func:`draw_points`, :func:`draw_polyline`,
:func:`draw_rect`, :func:`to_pixels`), and there is no ``fig_to_np``.
Those images are not pixel-matched to matplotlib's; the data they draw is
the same.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

GREEN = (0, 255, 0)      # correct coarse + correct fine (TP)
YELLOW = (255, 255, 0)   # correct coarse, wrong fine
RED = (255, 0, 0)        # false negative (inside labelled, predicted out)
BLUE = (0, 0, 255)       # false positive (outside labelled, predicted in)
GRID = (64, 64, 64)

# cv2.circle(img, c, r, color, -1): the half-width of the filled disc on
# each row dy = -r .. r (cv2's LINE_8 fill, checked against cv2 5.0.0)
DISC_HALF_WIDTHS = {0: (0,), 1: (0, 1, 0), 2: (0, 1, 2, 1, 0),
                    3: (0, 2, 2, 3, 2, 2, 0)}


def disc_offsets(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """(dy, dx) of the pixels of a filled ``cv2.circle`` of ``radius``."""
    if radius not in DISC_HALF_WIDTHS:
        raise ValueError(f"radius {radius}: only the filled discs of radius "
                         f"{sorted(DISC_HALF_WIDTHS)} are drawn (cv2's "
                         "stencils)")
    dy, dx = [], []
    for row, half in enumerate(DISC_HALF_WIDTHS[radius]):
        for x in range(-half, half + 1):
            dy.append(row - radius)
            dx.append(x)
    return np.asarray(dy), np.asarray(dx)


def draw_points(canvas: np.ndarray, x: np.ndarray, y: np.ndarray,
                colors, radius: int = 1) -> np.ndarray:
    """Filled discs at integer centres (x, y) (N,), in index order: a later
    point overwrites an earlier one.  ``colors`` is one RGB tuple or (N, 3)
    uint8.  Discs are clipped to the canvas; draws in place and returns
    the canvas."""
    x = np.asarray(x, np.int64).reshape(-1)
    y = np.asarray(y, np.int64).reshape(-1)
    if x.size == 0:
        return canvas
    Hc, Wc = canvas.shape[:2]
    dy, dx = disc_offsets(radius)
    py = (y[:, None] + dy[None]).reshape(-1)
    px = (x[:, None] + dx[None]).reshape(-1)
    idx = np.repeat(np.arange(x.size), dy.size)
    ok = (px >= 0) & (px < Wc) & (py >= 0) & (py < Hc)
    owner = np.full((Hc, Wc), -1, np.int64)
    np.maximum.at(owner, (py[ok], px[ok]), idx[ok])
    hit = owner >= 0
    cols = np.asarray(colors, np.uint8)
    canvas[hit] = cols if cols.ndim == 1 else cols[owner[hit]]
    return canvas


def _line_axis(canvas, x0: int, y0: int, x1: int, y1: int, color):
    """A 1-px vertical or horizontal ``cv2.line``, both ends drawn."""
    Hc, Wc = canvas.shape[:2]
    if x0 == x1:
        if 0 <= x0 < Wc:
            lo, hi = max(min(y0, y1), 0), min(max(y0, y1), Hc - 1)
            if lo <= hi:
                canvas[lo:hi + 1, x0] = color
    elif y0 == y1:
        if 0 <= y0 < Hc:
            lo, hi = max(min(x0, x1), 0), min(max(x0, x1), Wc - 1)
            if lo <= hi:
                canvas[y0, lo:hi + 1] = color
    else:
        raise ValueError("only axis-aligned lines are drawn")


def draw_polyline(canvas: np.ndarray, x: Sequence[float],
                  y: Sequence[float], color) -> np.ndarray:
    """Segments through the pixel positions (x, y), each sampled at every
    pixel step of its longer axis; clipped to the canvas."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    Hc, Wc = canvas.shape[:2]
    for i in range(len(x) - 1):
        if not np.all(np.isfinite([x[i], x[i + 1], y[i], y[i + 1]])):
            continue
        n = int(max(abs(x[i + 1] - x[i]), abs(y[i + 1] - y[i]), 1.0)) + 1
        s = np.linspace(0.0, 1.0, n)
        xs = np.rint(x[i] + s * (x[i + 1] - x[i])).astype(np.int64)
        ys = np.rint(y[i] + s * (y[i + 1] - y[i])).astype(np.int64)
        ok = (xs >= 0) & (xs < Wc) & (ys >= 0) & (ys < Hc)
        canvas[ys[ok], xs[ok]] = color
    return canvas


def draw_rect(canvas: np.ndarray, x0: float, y0: float, x1: float,
              y1: float, color) -> np.ndarray:
    """The outline of the axis-aligned rectangle of pixel corners
    (x0, y0)-(x1, y1), clipped to the canvas."""
    a, b = int(round(x0)), int(round(x1))
    c, d = int(round(y0)), int(round(y1))
    for args in ((a, c, b, c), (a, d, b, d), (a, c, a, d), (b, c, b, d)):
        _line_axis(canvas, *args, color)
    return canvas


def to_pixels(x, y, xlim, ylim, box: Tuple[int, int, int, int],
              flip_y: bool = True):
    """Data coordinates -> integer pixel coordinates of the panel ``box``
    (left, top, width, height) showing ``xlim`` x ``ylim``; y grows up
    unless ``flip_y`` is False (image coordinates)."""
    left, top, w, h = box
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    u = left + (x - xlim[0]) / (xlim[1] - xlim[0]) * (w - 1)
    t = (y - ylim[0]) / (ylim[1] - ylim[0]) * (h - 1)
    v = top + ((h - 1) - t if flip_y else t)
    return u, v


def jet(values: np.ndarray) -> np.ndarray:
    """(N,) scalars -> (N, 3) uint8 RGB of the jet colour map over their
    range."""
    v = np.asarray(values, np.float64).reshape(-1)
    lo, hi = (np.nanmin(v), np.nanmax(v)) if v.size else (0.0, 1.0)
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    rgb = np.clip(np.stack([1.5 - np.abs(4.0 * t - 3.0),
                            1.5 - np.abs(4.0 * t - 2.0),
                            1.5 - np.abs(4.0 * t - 1.0)], -1), 0.0, 1.0)
    return (rgb * 255.0).astype(np.uint8)


def point_colors(color, n: int) -> np.ndarray:
    """A scatter's ``c=``: None (blue), (N,) scalars (jet), (N, 3) RGB in
    [0, 1] -> (N, 3) uint8."""
    if color is None:
        return np.tile(np.array([[31, 119, 180]], np.uint8), (n, 1))
    c = np.asarray(color)
    if c.ndim == 1:
        return jet(c)
    return np.clip(np.rint(c[:, :3].astype(np.float64) * 255.0), 0,
                   255).astype(np.uint8)


def view_project(pts: np.ndarray, elev: float, azim: float):
    """Orthographic screen coordinates (right, up) of (N, 3) points seen
    from elevation ``elev`` and azimuth ``azim`` degrees, z up (the
    convention of a matplotlib 3-D axis)."""
    e, a = math.radians(elev), math.radians(azim)
    p = np.asarray(pts, np.float64)
    right = -math.sin(a) * p[:, 0] + math.cos(a) * p[:, 1]
    up = (-math.sin(e) * (math.cos(a) * p[:, 0] + math.sin(a) * p[:, 1])
          + math.cos(e) * p[:, 2])
    return right, up


def _limits(v: np.ndarray, margin: float = 0.05):
    v = v[np.isfinite(v)]
    if v.size == 0:
        return (-1.0, 1.0)
    lo, hi = float(v.min()), float(v.max())
    pad = max(hi - lo, 1e-6) * margin
    return (lo - pad, hi + pad)


def scatter_panel(canvas: np.ndarray, x, y, colors, box, *, radius: int = 1,
                  equal: bool = False, frame=(0, 0, 0)) -> np.ndarray:
    """A framed panel in ``box`` of the points (x, y), coloured (N, 3),
    limits fitted to the data (equal scales on both axes if ``equal``)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xlim, ylim = _limits(x), _limits(y)
    if equal:
        left, top, w, h = box
        span = max((xlim[1] - xlim[0]) / max(w - 1, 1),
                   (ylim[1] - ylim[0]) / max(h - 1, 1))
        cx, cy = sum(xlim) / 2, sum(ylim) / 2
        xlim = (cx - span * (w - 1) / 2, cx + span * (w - 1) / 2)
        ylim = (cy - span * (h - 1) / 2, cy + span * (h - 1) / 2)
    u, v = to_pixels(x, y, xlim, ylim, box)
    ok = np.isfinite(u) & np.isfinite(v)
    draw_points(canvas, np.rint(u[ok]), np.rint(v[ok]),
                np.asarray(colors)[ok], radius)
    left, top, w, h = box
    return draw_rect(canvas, left, top, left + w - 1, top + h - 1, frame)


def plot_pc(pc: np.ndarray, color=None, size: float = 1.0, *,
            elev: float = 30.0, azim: float = -60.0,
            shape: Tuple[int, int] = (480, 480)) -> np.ndarray:
    """An (H, W, 3) uint8 image of the (N, 3) cloud seen from (elev,
    azim) on white, the counterpart of the JAX package's 3-D scatter
    (``color``: None, (N,) scalars on the jet map, or (N, 3) RGB in
    [0, 1]; ``size`` >= 2 draws discs of radius 1)."""
    H, W = shape
    canvas = np.full((H, W, 3), 255, np.uint8)
    pc = np.asarray(pc)
    x, y = view_project(pc, elev, azim)
    m = 8
    return scatter_panel(canvas, x, y, point_colors(color, len(pc)),
                         (m, m, W - 2 * m, H - 2 * m),
                         radius=1 if size >= 2 else 0, equal=True)


def grid(images: List[np.ndarray], cols: int = 2) -> np.ndarray:
    """Tile same-sized images row-major into one canvas."""
    if not images:
        return np.zeros((1, 1, 3), np.uint8)
    h, w = images[0].shape[:2]
    rows = (len(images) + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = img[:h, :w]
    return canvas


def _round_px(v: np.ndarray) -> np.ndarray:
    """``int(round(v))`` per element (half to even); non-finite -> a
    sentinel far off any canvas."""
    v = np.asarray(v)
    out = np.full(v.shape, np.iinfo(np.int64).min // 2, np.int64)
    ok = np.isfinite(v)
    out[ok] = np.rint(v[ok]).astype(np.int64)
    return out


def classification_overlay(pxpy: np.ndarray,
                           coarse_pred: np.ndarray, coarse_label: np.ndarray,
                           img: np.ndarray,
                           fine_pred: Optional[np.ndarray] = None,
                           fine_label: Optional[np.ndarray] = None,
                           fine_scale: int = 32, pad: int = 100,
                           radius: int = 1) -> np.ndarray:
    """Per-point classification quality on an enlarged image canvas: TP
    green (yellow where the fine cell is wrong), FN red, FP blue, the fine
    grid in gray (reference ``vis_tools.py:147-339``).

    Args:
      pxpy: (N, 2) projected pixel coordinates (full resolution);
      img: (H, W, 3) uint8 or float image.
    """
    disc_offsets(radius)
    H, W = img.shape[:2]
    canvas = np.zeros((H + 2 * pad, W + 2 * pad, 3), np.uint8)
    canvas[pad:pad + H, pad:pad + W] = img.astype(np.uint8)
    for gx in range(0, W + 1, fine_scale):
        _line_axis(canvas, pad + gx, pad, pad + gx, pad + H, GRID)
    for gy in range(0, H + 1, fine_scale):
        _line_axis(canvas, pad, pad + gy, pad + W, pad + gy, GRID)

    x = _round_px(pxpy[:, 0]) + pad
    y = _round_px(pxpy[:, 1]) + pad
    on = (x >= 0) & (x < canvas.shape[1]) & (y >= 0) & (y < canvas.shape[0])
    lab = np.asarray(coarse_label).astype(np.int64)
    pred = np.asarray(coarse_pred).astype(np.int64)
    colors = np.zeros((len(x), 3), np.uint8)
    tp = (lab == 1) & (pred == 1)
    colors[tp] = GREEN
    if fine_pred is not None and fine_label is not None:
        wrong = (np.asarray(fine_pred).astype(np.int64)
                 != np.asarray(fine_label).astype(np.int64))
        colors[tp & wrong] = YELLOW
    fn = (lab == 1) & (pred == 0)
    fp = (lab == 0) & (pred == 1)
    colors[fn] = RED
    colors[fp] = BLUE
    keep = on & (tp | fn | fp)
    return draw_points(canvas, x[keep], y[keep], colors[keep], radius)


def registration_overlay(pc: np.ndarray, P: np.ndarray, K: np.ndarray,
                         pred_inside: np.ndarray, img: np.ndarray,
                         radius: int = 1) -> np.ndarray:
    """Project the cloud through an estimated pose and mark the
    predicted-inside points on the image in red (``vis_tools.py:96-145``)."""
    disc_offsets(radius)
    out = img.astype(np.uint8).copy()
    H, W = out.shape[:2]
    cam = pc @ P[:3, :3].T + P[:3, 3]
    front = cam[:, 2] > 0.1
    px = K[0, 0] * cam[:, 0] / np.maximum(cam[:, 2], 1e-6) + K[0, 2]
    py = K[1, 1] * cam[:, 1] / np.maximum(cam[:, 2], 1e-6) + K[1, 2]
    sel = np.nonzero(front & (pred_inside > 0))[0]
    x, y = _round_px(px[sel]), _round_px(py[sel])
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    return draw_points(out, x[ok], y[ok], RED, radius)
