"""Solver debugging images, counterpart of the JAX package's
``eval/debug_vis.py`` (reference ``evaluation/gauss_newton_visualization.py``
and ``evaluation/visualization_for_paper.py``):

* :func:`solver_trace` runs the analytic-Jacobian LM one iteration at a
  time and records the cost and the pose after each;
* :func:`tp_fp_fn_colors` colours each point TP green, wrong-fine yellow,
  FN red, FP blue, true negative gray (``visualization_for_paper.py:
  106-122``), bitwise the JAX package's;
* :func:`trace_figure`, :func:`scene_figure` and :func:`iteration_overlay`
  draw what the JAX package's matplotlib figures draw, with the port's own
  rasterizer (:mod:`..utils.vis`) and no text: they are not pixel-matched;
* :func:`debug_report` writes the three images of one dumped sample as
  PNGs and returns its final cost, RTE and RRE (``eval.cli solve
  --debug-vis``).
"""
from __future__ import annotations

import math
import os
from typing import List

import numpy as np
import torch

from ..register.frustum import initial_guess, theta_to_pose
from ..register.frustum_fast import lm_solve_fast
from ..register.metrics import pose_diff_np
from ..utils import vis
from ..utils.png import write_png
from .dump import load_dump

BLACK, GRAY = (0, 0, 0), (160, 160, 160)
LIME = (0, 255, 0)
LINE = (31, 119, 180)
PANEL_W = 420


def solver_trace(pc, labels, K, *, H: int, W: int, theta0,
                 n_steps: int = 32, t_lb=(-5.0, -0.1, -10.0),
                 t_ub=(5.0, 0.1, 10.0)):
    """Cost trajectory of one LM problem: ``n_steps`` calls of
    :func:`lm_solve_fast` with ``max_iter=1``, each restarting the damping
    at 1e-3 (what the JAX package's trace records).  Runs on the device of
    ``pc`` (a tensor; numpy arrays run on the CPU).  Returns (costs, poses
    (4, 4) float32 numpy)."""
    dev = pc.device if isinstance(pc, torch.Tensor) else torch.device("cpu")

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    theta = f32(theta0)[None, None]
    pts = f32(pc)[None]
    lab = f32(labels)[None]
    val = torch.ones_like(lab)
    Kb = f32(K)[None]
    costs: List[float] = []
    poses = []
    for _ in range(n_steps):
        theta, cost, _ = lm_solve_fast(pts, lab, val, Kb, theta, t_lb, t_ub,
                                       H=H, W=W, max_iter=1)
        costs.append(float(cost[0, 0]))
        poses.append(theta_to_pose(theta[0, 0], True).cpu().numpy())
    return costs, poses


def tp_fp_fn_colors(coarse_pred: np.ndarray, coarse_label: np.ndarray,
                    fine_pred=None, fine_label=None) -> np.ndarray:
    """(N, 3) float RGB per point: TP green / wrong-fine yellow / FN red /
    FP blue / true-negative gray."""
    n = len(coarse_pred)
    colors = np.full((n, 3), 0.6)
    tp = (coarse_pred == 1) & (coarse_label == 1)
    colors[tp] = (0, 1, 0)
    if fine_pred is not None and fine_label is not None:
        colors[tp & (fine_pred != fine_label)] = (1, 1, 0)
    colors[(coarse_pred == 0) & (coarse_label == 1)] = (1, 0, 0)
    colors[(coarse_pred == 1) & (coarse_label == 0)] = (0, 0, 1)
    return colors


def trace_figure(costs: List[float], shape=(300, 500)) -> np.ndarray:
    """The cost against the LM iteration, log y, in a framed box on white:
    (H, W, 3) uint8."""
    Hc, Wc = shape
    canvas = np.full((Hc, Wc, 3), 255, np.uint8)
    m = 20
    box = (m, m, Wc - 2 * m, Hc - 2 * m)
    y = np.log10(np.maximum(np.asarray(costs, np.float64), 1e-30))
    x = np.arange(len(y), dtype=np.float64)
    xlim = (-0.5, max(len(y) - 0.5, 0.5))
    lo, hi = (float(y.min()), float(y.max())) if len(y) else (0.0, 1.0)
    pad = max(hi - lo, 1e-3) * 0.08
    u, v = vis.to_pixels(x, y, xlim, (lo - pad, hi + pad), box)
    vis.draw_polyline(canvas, u, v, LINE)
    vis.draw_points(canvas, np.rint(u), np.rint(v), LINE, 1)
    vis.draw_rect(canvas, box[0], box[1], box[0] + box[2] - 1,
                  box[1] + box[3] - 1, BLACK)
    return canvas


def scene_figure(pc: np.ndarray, coarse_pred, coarse_label,
                 fine_pred=None, fine_label=None,
                 shape=(400, 800)) -> np.ndarray:
    """TP/FP/FN scene render: a top-down (x, z) panel at equal scales and
    an oblique panel (elevation 35, azimuth -60 degrees, -y up), points
    coloured by :func:`tp_fp_fn_colors`: (H, W, 3) uint8."""
    Hc, Wc = shape
    canvas = np.full((Hc, Wc, 3), 255, np.uint8)
    colors = vis.point_colors(tp_fp_fn_colors(
        np.asarray(coarse_pred), np.asarray(coarse_label),
        None if fine_pred is None else np.asarray(fine_pred),
        None if fine_label is None else np.asarray(fine_label)), len(pc))
    pc = np.asarray(pc, np.float64)
    m, half = 16, Wc // 2
    vis.scatter_panel(canvas, pc[:, 0], pc[:, 2], colors,
                      (m, m, half - 2 * m, Hc - 2 * m), equal=True)
    ox, oy = vis.view_project(np.stack([pc[:, 0], pc[:, 2], -pc[:, 1]], -1),
                              35.0, -60.0)
    vis.scatter_panel(canvas, ox, oy, colors,
                      (half + m, m, half - 2 * m, Hc - 2 * m), equal=True,
                      radius=0)
    return canvas


def _project(pc, P, K):
    cam = pc @ np.asarray(P)[:3, :3].T + np.asarray(P)[:3, 3]
    z = cam[:, 2]
    zs = np.where(z > 0.1, z, 1.0)
    px = K[0, 0] * cam[:, 0] / zs + K[0, 2]
    py = K[1, 1] * cam[:, 1] / zs + K[1, 2]
    return px, py, z > 0.1


def _overlay_panel(canvas, box, img, pc_in, P, K, H: int, W: int):
    """One iteration panel: the image (or white) on the frame [0, W] x
    [0, H], the inside points through P (lime in front, red behind), the
    frame, all within [-0.6 W, 1.6 W] x [-0.6 H, 1.6 H]."""
    xlim, ylim = (-0.6 * W, 1.6 * W), (-0.6 * H, 1.6 * H)
    left, top, w, h = box
    (u0, u1), (v0, v1) = (np.rint(a).astype(int) for a in vis.to_pixels(
        [0, W], [0, H], xlim, ylim, box, flip_y=False))
    if img is not None:
        im = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        uu = np.arange(u0, u1 + 1)
        vv = np.arange(v0, v1 + 1)
        sx = np.clip(((uu - u0) / max(u1 - u0, 1) * W).astype(int), 0,
                     im.shape[1] - 1)
        sy = np.clip(((vv - v0) / max(v1 - v0, 1) * H).astype(int), 0,
                     im.shape[0] - 1)
        canvas[v0:v1 + 1, u0:u1 + 1] = im[sy[:, None], sx[None, :], :3]
    px, py, front = _project(pc_in, P, K)
    u, v = vis.to_pixels(px, py, xlim, ylim, box, flip_y=False)
    inside = (np.isfinite(u) & np.isfinite(v) & (u >= left)
              & (u < left + w) & (v >= top) & (v < top + h))
    for sel, col in ((front & inside, LIME), (~front & inside, vis.RED)):
        vis.draw_points(canvas, np.rint(u[sel]), np.rint(v[sel]), col, 0)
    vis.draw_rect(canvas, u0, v0, u1, v1, BLACK)
    vis.draw_rect(canvas, left, top, left + w - 1, top + h - 1, GRAY)


def iteration_overlay(pc: np.ndarray, pred_inside: np.ndarray, poses,
                      K: np.ndarray, *, H: int, W: int, P_gt=None,
                      img: np.ndarray = None,
                      iters=(0, None, -1)) -> np.ndarray:
    """The inside-predicted points through the pose of selected iterations
    (None: the middle one), and through ``P_gt`` if given, one panel each
    side by side (``gauss_newton_visualization.py:105-152``, made
    visual): (H', W', 3) uint8."""
    sel = [i if i is not None else len(poses) // 2 for i in iters]
    panels = [poses[i] for i in sel] + ([P_gt] if P_gt is not None else [])
    inside = np.asarray(pred_inside) == 1
    pc_in = np.asarray(pc)[inside]
    pw = PANEL_W
    ph = max(int(round(pw * H / W)), 60)
    m = 8
    canvas = np.full((ph + 2 * m, len(panels) * (pw + m) + m, 3), 255,
                     np.uint8)
    for k, P in enumerate(panels):
        _overlay_panel(canvas, (m + k * (pw + m), m, pw, ph), img, pc_in,
                       np.asarray(P), np.asarray(K), H, W)
    return canvas


def debug_report(data_dir: str, prefix: str, *, H: int, W: int,
                 out_dir: str, n_steps: int = 32, use_labels: bool = False,
                 device="cuda") -> dict:
    """One dumped sample's solver debug images in ``out_dir``:
    ``{prefix}_trace.png`` (the cost trace from the yaw of the initial
    guess with t = 0), ``_scene.png`` (TP/FP/FN) and ``_overlay.png``
    (the initial pose, iterations 0, n/2 and last, and the GT pose), as the
    reference's ``gauss_newton_visualization.py`` main (``:105-152``).
    The trace runs on ``device`` (default: the card).  Returns
    ``{"prefix", "final_cost", "rte", "rre"}``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    d = load_dump(data_dir, prefix)
    pred = d["coarse_label"] if use_labels else d["coarse_pred"]
    pc_t = torch.as_tensor(d["pc"], dtype=torch.float32, device=dev)
    ang, _ = initial_guess(pc_t[None], torch.as_tensor(pred, device=dev)[None])
    theta0 = np.array([float(ang[0]), 0.0, 0.0, 0.0], np.float32)
    costs, poses = solver_trace(pc_t, pred.astype(np.float32),
                                d["K"].astype(np.float32), H=H, W=W,
                                theta0=theta0, n_steps=n_steps)
    rte, rre = pose_diff_np(np.asarray(poses[-1], np.float64), d["P"])

    write_png(os.path.join(out_dir, prefix + "_trace.png"),
              trace_figure(costs))
    write_png(os.path.join(out_dir, prefix + "_scene.png"),
              scene_figure(d["pc"], d["coarse_pred"], d["coarse_label"],
                           d["fine_pred"], d["fine_label"]))
    img_path = os.path.join(data_dir, prefix + "_img.npy")
    img = np.load(img_path) if os.path.isfile(img_path) else None
    P0 = np.eye(4)
    c0, s0 = math.cos(theta0[0]), math.sin(theta0[0])
    P0[:3, :3] = [[c0, 0, s0], [0, 1, 0], [-s0, 0, c0]]
    write_png(os.path.join(out_dir, prefix + "_overlay.png"),
              iteration_overlay(d["pc"], pred, [P0] + list(poses), d["K"],
                                H=H, W=W, P_gt=d["P"], img=img))
    return {"prefix": prefix, "final_cost": costs[-1],
            "rte": float(rte), "rre": float(rre)}
