"""The port's images without OpenCV or matplotlib: the PNG writer against
``cv2.imread`` and the port's ``read_png``; ``utils/vis.py`` overlays and
``grid`` bitwise the JAX package's (which draws with cv2); and
``eval/debug_vis.py`` against the JAX package's solver trace and debug
report, with its callers (``dump_predictions(viz_dir=...)``, ``eval.cli
solve --debug-vis``, ``MMClassifier.write_classification_visualization``)."""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from deepi2p_tpu.eval import debug_vis as jdv
from deepi2p_tpu.utils import vis as jvis
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.data.jpeg import read_png
from deepi2p_tpu_torch.eval import cli as eval_cli
from deepi2p_tpu_torch.eval import debug_vis as tdv
from deepi2p_tpu_torch.eval.dump import dump_predictions, save_sample_dump
from deepi2p_tpu_torch.models import build_detector
from deepi2p_tpu_torch.ops.projection import coarse_labels, project_points
from deepi2p_tpu_torch.utils import vis as tvis
from deepi2p_tpu_torch.utils.logging import MetricsLogger
from deepi2p_tpu_torch.utils.png import encode_png, write_png
from test_torch_port_train_parts import one_torch_thread  # noqa: F401

H, W = 64, 96
K = np.array([[50.0, 0, 48], [0, 50, 32], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 1), (33, 17, 3),
                                   (1, 1, 3), (64, 96, 3)])
def test_png_decodes_to_the_same_pixels(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    rgb = np.repeat(img.reshape(shape[0], shape[1], -1), 3 // (
        img.size // (shape[0] * shape[1])), axis=2)
    got_cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if got_cv.ndim == 3:
        got_cv = cv2.cvtColor(got_cv, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got_cv, img.reshape(got_cv.shape))
    np.testing.assert_array_equal(read_png(path), rgb)
    assert read_png(encode_png(img)).shape == (shape[0], shape[1], 3)


def test_png_refuses_what_it_cannot_write():
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        encode_png(np.zeros((4, 4, 4), np.uint8))


def test_log_image(tmp_path):
    """``{tag}_{step}.png`` with '/' made '_', and an image summary in the
    event file when TensorBoard's protos import."""
    img = np.random.default_rng(0).integers(0, 256, (12, 20, 3)).astype(
        np.uint8)
    log = MetricsLogger(str(tmp_path))
    log.log_image("vis/classification", img, 7)
    log.close()
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "vis_classification_7.png")), img)
    if log._tb is None:
        return
    from test_torch_port_train_cli import _events
    ev = [f for f in os.listdir(tmp_path) if f.startswith("events.")]
    images = [v.image for e in _events(str(tmp_path / ev[0]))
              for v in e.summary.value if v.HasField("image")]
    assert len(images) == 1 and (images[0].height, images[0].width) == (
        12, 20)
    np.testing.assert_array_equal(
        read_png(images[0].encoded_image_string), img)


def test_grid_bitwise():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
            for _ in range(5)]
    for cols in (1, 2, 3):
        np.testing.assert_array_equal(tvis.grid(imgs, cols),
                                      jvis.grid(imgs, cols))
    np.testing.assert_array_equal(tvis.grid([]), jvis.grid([]))


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("fine", [False, True])
@pytest.mark.parametrize("pad", [0, 20])
def test_classification_overlay_bitwise(radius, fine, pad):
    """Points off, on and across the canvas edges, overlapping discs
    (the later point wins), coordinates exactly on .5 (half to even),
    float and uint8 images, with and without the fine labels."""
    rng = np.random.default_rng(radius * 10 + pad + fine)
    n = 600
    img = rng.uniform(0, 300, (H, W, 3)).astype(np.float32)
    pxpy = rng.uniform(-25, 120, (n, 2)).astype(np.float32)
    pxpy[:40] = np.round(pxpy[:40]) + 0.5
    pxpy[40:80] = pxpy[80:120] + rng.uniform(-1.5, 1.5, (40, 2))
    cp, cl = rng.integers(0, 2, n), rng.integers(0, 2, n)
    fp, fl = rng.integers(0, 4, n), rng.integers(0, 4, n)
    kw = dict(fine_scale=16, pad=pad, radius=radius)
    if fine:
        kw.update(fine_pred=fp, fine_label=fl)
    for im in (img, img.clip(0, 255).astype(np.uint8)):
        got = tvis.classification_overlay(pxpy, cp, cl, im, **kw)
        want = jvis.classification_overlay(pxpy, cp, cl, im, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_registration_overlay_bitwise(radius):
    rng = np.random.default_rng(radius)
    n = 800
    img = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    pc = rng.normal(scale=5, size=(n, 3)).astype(np.float32)
    pc[:, 2] += 8
    P = np.eye(4, dtype=np.float32)
    P[:3, 3] = (0.3, -0.2, 0.5)
    inside = rng.integers(0, 2, n)
    np.testing.assert_array_equal(
        tvis.registration_overlay(pc, P, K, inside, img, radius),
        jvis.registration_overlay(pc, P, K, inside, img, radius))


def test_radius_outside_the_stencils_raises():
    pxpy = np.zeros((1, 2), np.float32)
    one = np.ones(1, np.int64)
    with pytest.raises(ValueError, match="radius 4"):
        tvis.classification_overlay(pxpy, one, one,
                                    np.zeros((8, 8, 3), np.uint8), radius=4)
    with pytest.raises(ValueError, match="radius 5"):
        tvis.registration_overlay(np.ones((1, 3), np.float32), np.eye(4),
                                  K, one, np.zeros((8, 8, 3)), radius=5)


def test_tp_fp_fn_colors_bitwise():
    rng = np.random.default_rng(3)
    cp, cl = rng.integers(0, 2, 300), rng.integers(0, 2, 300)
    fp, fl = rng.integers(0, 3, 300), rng.integers(0, 3, 300)
    for args in ((cp, cl), (cp, cl, fp, fl)):
        got, want = tdv.tp_fp_fn_colors(*args), jdv.tp_fp_fn_colors(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _ring(rng, n):
    th = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(5, 20, n)
    pc = np.stack([r * np.cos(th), rng.uniform(-1, 1, n), r * np.sin(th)],
                  -1).astype(np.float32)
    pxpy, z = project_points(torch.as_tensor(pc[None]),
                             torch.as_tensor(np.eye(4, dtype=np.float32)[None,
                                                                         :3]),
                             torch.as_tensor(K[None]))
    return pc, coarse_labels(pxpy, z, H, W)[0].numpy()


def _trace64(pc, labels, theta0, n_steps):
    """The trace's costs in float64: each step one damped solve from
    lam = 1e-3, accepted if it lowers the cost."""
    from deepi2p_tpu_torch.register.frustum_cuda import _chol_solve, _clip_t
    from deepi2p_tpu_torch.register.frustum_fast import (_normal_equations,
                                                         _residual_cost)
    d = torch.float64
    xs, ys, zs = (torch.as_tensor(pc, dtype=d)[None, None, :, i]
                  for i in range(3))
    lab = torch.as_tensor(labels, dtype=d)[None, None]
    val = torch.ones_like(lab)
    k = [torch.tensor(v, dtype=d).reshape(1, 1, 1)
         for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2])]
    args = (xs, ys, zs, lab, val, *k, H - 1.0, W - 1.0)
    theta = torch.tensor(theta0, dtype=d)[None, None]
    upper = [(i, j) for i in range(4) for j in range(i, 4)]
    bounds = ((-5.0, -0.1, -10.0), (5.0, 0.1, 10.0))
    cost, costs = _residual_cost(theta, *args), []
    for _ in range(n_steps):
        Hm, g, _ = _normal_equations(theta, *args)
        Hu = torch.stack([Hm[..., i, j] for i, j in upper], -1)
        new = _clip_t(theta - _chol_solve(Hu, g, torch.full(
            (1, 1), 1e-3, dtype=d)), *bounds)
        c = _residual_cost(new, *args)
        if bool(c < cost):
            theta, cost = new, c
        costs.append(float(cost))
    return np.array(costs)


@pytest.mark.parametrize("theta0", [[0.1, 0.0, 0.0, 0.5],
                                    [-0.2, 0.5, 0.0, -1.0]])
def test_solver_trace_matches_jax(theta0):
    """Each step's cost within 1e-4 relative of the JAX trace's, plus the
    JAX trace's own distance from the float64 trace: the first step from
    (0.1, 0, 0, 0.5) solves normal equations of condition ~1.7e7, where
    the JAX package's f32 cost is 1.7e-4 off the float64 one and the
    port's 2.5e-5.  The poses within 1e-3."""
    pc, labels = _ring(np.random.default_rng(0), 128)
    c_t, p_t = tdv.solver_trace(pc, labels, K, H=H, W=W, theta0=theta0,
                                n_steps=8)
    c_j, p_j = jdv.solver_trace(pc, labels, K, H=H, W=W, theta0=theta0,
                                n_steps=8)
    c_t, c_j = np.asarray(c_t), np.asarray(c_j)
    c64 = _trace64(pc, labels, theta0, 8)
    assert np.all(np.abs(c_t - c_j) <= 1e-4 * np.abs(c_j)
                  + np.abs(c_j - c64)), (c_t, c_j, c64)
    np.testing.assert_allclose(np.stack(p_t), np.stack(p_j), atol=1e-3)
    assert c_t[-1] <= c_t[0] + 1e-6


@pytest.fixture
def dump_dir(tmp_path):
    """A fabricated dump (as ``tests/test_aux.py:223`` builds one): a
    ring cloud, labels from the identity pose, a float image."""
    rng = np.random.default_rng(1)
    d = tmp_path / "dump"
    d.mkdir()
    for i in range(2):
        pc, labels = _ring(rng, 256)
        pred = labels.copy()
        pred[rng.random(len(pred)) < 0.05] ^= 1
        save_sample_dump(str(d), f"{i:06d}_00", pc=pc, coarse_pred=pred,
                         coarse_label=labels,
                         fine_pred=rng.integers(0, 6, 256),
                         fine_label=rng.integers(0, 6, 256), K=K,
                         P=np.eye(4, dtype=np.float32)[:3])
        np.save(d / f"{i:06d}_00_img.npy",
                rng.uniform(0, 255, (H, W, 3)).astype(np.float32))
    return str(d)


@pytest.mark.parametrize("use_labels", [False, True])
def test_debug_report_matches_jax(dump_dir, tmp_path, use_labels):
    """The same keys, the final cost within 1e-4 relative, RTE and RRE
    within 1e-4; three PNGs that ``read_png`` decodes."""
    kw = dict(H=H, W=W, n_steps=6, use_labels=use_labels)
    got = tdv.debug_report(dump_dir, "000001_00", out_dir=str(tmp_path / "t"),
                           device="cpu", **kw)
    want = jdv.debug_report(dump_dir, "000001_00",
                            out_dir=str(tmp_path / "j"), **kw)
    assert set(got) == set(want) and got["prefix"] == want["prefix"]
    np.testing.assert_allclose(got["final_cost"], want["final_cost"],
                               rtol=1e-4)
    for k in ("rte", "rre"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4)
    for suffix in ("_trace.png", "_scene.png", "_overlay.png"):
        img = read_png(str(tmp_path / "t" / ("000001_00" + suffix)))
        assert img.ndim == 3 and img.shape[0] > 100
        assert len(np.unique(img.reshape(-1, 3), axis=0)) > 2, suffix


def test_figures_draw_their_data():
    """The rasterised figures: the trace's line spans the box, the scene
    shows each class colour, the overlay one panel per iteration and the
    GT, the image inside the frame; ``plot_pc`` an image of the cloud."""
    tr = tdv.trace_figure([10.0, 5.0, 2.0, 1.5, 1.4])
    assert tr.shape == (300, 500, 3)
    assert (np.all(tr == tdv.LINE, axis=-1)).sum() > 300
    rng = np.random.default_rng(2)
    pc, labels = _ring(rng, 400)
    pred = labels.copy()
    pred[:40] ^= 1
    sc = tdv.scene_figure(pc, pred, labels)
    for col in ((0, 255, 0), (255, 0, 0), (0, 0, 255), (153, 153, 153)):
        assert np.all(sc == col, axis=-1).any(), col
    img = np.full((H, W, 3), 200.0, np.float32)
    ov = tdv.iteration_overlay(pc, labels, [np.eye(4)] * 5, K, H=H, W=W,
                               P_gt=np.eye(4), img=img)
    assert ov.shape[1] == 4 * (tdv.PANEL_W + 8) + 8
    assert np.all(ov == 200, axis=-1).sum() > 4 * 1000
    assert np.all(ov == tdv.LIME, axis=-1).any()
    im = tvis.plot_pc(pc, color=labels, size=2.0)
    assert im.shape == (480, 480, 3) and (im != 255).any()


def test_dump_predictions_viz_dir(tmp_path):
    """``{id}_img.png`` is the batch image cast to uint8, and
    ``{id}_prediction.png`` the TP/FP/FN overlay of the dumped
    predictions and labels."""
    cfg = config.tiny()
    batch = synthetic_batch(cfg, seed=3)
    model = build_detector(cfg, device="cpu", seed=0)
    out, viz = str(tmp_path / "dump"), str(tmp_path / "viz")
    dump_predictions(model, [batch], cfg, out, viz_dir=viz)
    from deepi2p_tpu_torch.eval.dump import load_dump
    from deepi2p_tpu_torch.ops.projection import generate_labels
    lab = generate_labels(*(torch.as_tensor(batch[k]) for k in ("pc", "P",
                                                               "K")),
                          cfg.img_H, cfg.img_W, cfg.img_fine_resolution_scale)
    for b in range(cfg.batch_size):
        prefix = f"{b:06d}_00"
        img = batch["img"][b].astype(np.uint8)
        np.testing.assert_array_equal(
            read_png(os.path.join(viz, prefix + "_img.png")), img)
        d = load_dump(out, prefix)
        want = tvis.classification_overlay(
            lab.pxpy[b].numpy(), d["coarse_pred"], d["coarse_label"], img,
            fine_pred=d["fine_pred"], fine_label=d["fine_label"],
            fine_scale=cfg.img_fine_resolution_scale)
        np.testing.assert_array_equal(
            read_png(os.path.join(viz, prefix + "_prediction.png")), want)


def test_cli_solve_debug_vis(dump_dir, tmp_path, capsys):
    out = str(tmp_path / "vis")
    eval_cli.main(["solve", "--data-dir", dump_dir, "--method", "frustum",
                   "--img-h", str(H), "--img-w", str(W), "--n-inits", "8",
                   "--max-iter", "8", "--debug-vis", out,
                   "--debug-vis-max", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    reports = [json.loads(x)["debug_vis"] for x in lines
               if x.startswith('{"debug_vis"')]
    assert [r["prefix"] for r in reports] == ["000000_00"]
    assert all(np.isfinite(reports[0][k]) for k in ("final_cost", "rte",
                                                     "rre"))
    assert sorted(os.listdir(out)) == [
        "000000_00_overlay.png", "000000_00_scene.png", "000000_00_trace.png"]


def test_classifier_visualization(tmp_path):
    from deepi2p_tpu_torch.ops.projection import generate_labels
    from deepi2p_tpu_torch.train.classifier import MMClassifier
    cfg = config.tiny()
    clf = MMClassifier(cfg, log_dir=str(tmp_path), device="cpu")
    batch = synthetic_batch(cfg, seed=0)
    clf.set_input(batch)
    canvas = clf.write_classification_visualization(out_step=5)
    coarse, fine = clf.inference_pass()
    lab = generate_labels(*(torch.as_tensor(batch[k]) for k in ("pc", "P",
                                                               "K")),
                          cfg.img_H, cfg.img_W, cfg.img_fine_resolution_scale)
    want = jvis.grid([jvis.classification_overlay(
        lab.pxpy[b].numpy(), coarse[b].numpy(), lab.coarse[b].numpy(),
        batch["img"][b], fine_pred=fine[b].numpy(),
        fine_label=lab.fine[b].numpy(), fine_scale=32)
        for b in range(cfg.batch_size)], cols=2)
    np.testing.assert_array_equal(canvas, want)
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "classification_5.png")), want)
    assert MMClassifier(cfg, device="cpu").write_classification_visualization(
    ) is None
