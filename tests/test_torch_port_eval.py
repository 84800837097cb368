"""The port's evaluation path against the JAX package: the dump format in
both directions, label generation, the pseudo-cloud dump, the harness's
methods on the JAX tests' own problems (test_register_extra.py:251-362),
the detector-driven dump, and the ``solve`` CLI.  Tolerances are stated
per test."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (port tests hold both frameworks)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.data.nuscenes import enu2cam as jax_enu2cam
from deepi2p_tpu.eval import dump as jdump
from deepi2p_tpu.eval.depth import dump_pseudo_pointclouds as jax_pseudo
from deepi2p_tpu.eval.harness import evaluate_registration as jax_eval
from deepi2p_tpu.ops.projection import generate_labels as jax_labels
from deepi2p_tpu.register.metrics import pose_diff_np as jax_pose_diff_np
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.data.nuscenes import enu2cam
from deepi2p_tpu_torch.eval import dump as tdump
from deepi2p_tpu_torch.eval.depth import dump_pseudo_pointclouds
from deepi2p_tpu_torch.eval.harness import evaluate_registration
from deepi2p_tpu_torch.models import build_detector
from deepi2p_tpu_torch.ops.projection import generate_labels
from deepi2p_tpu_torch.register.metrics import pose_diff_np

from test_register_extra import H, K_np, W, _pnp_problem

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("pc", "coarse_pred", "coarse_label", "fine_pred", "fine_label",
          "K", "P")


def _sample(rng, n=300):
    pc, coarse, fine, P = _pnp_problem(rng, yaw=rng.uniform(-1, 1),
                                       t=(rng.uniform(-2, 2), 0.0,
                                          rng.uniform(-2, 2)), n=n)
    pred = coarse.copy()
    pred[:7] = 1 - pred[:7]
    return dict(pc=pc, coarse_pred=pred, coarse_label=coarse,
                fine_pred=fine[::-1].copy(), fine_label=fine, K=K_np,
                P=P[:3])


@pytest.mark.parametrize("writer,reader", [(tdump, jdump), (jdump, tdump)])
def test_dump_files_cross_load(tmp_path, writer, reader):
    """A dump written by one package loads in the other to equal arrays,
    and the files are byte for byte those the other would write."""
    rng = np.random.default_rng(0)
    samples = [_sample(rng) for _ in range(2)]
    for i, s in enumerate(samples):
        writer.save_sample_dump(str(tmp_path), f"{i:06d}_00", **s)
    assert reader.list_dump_prefixes(str(tmp_path)) == ["000000_00",
                                                        "000001_00"]
    for i, s in enumerate(samples):
        d = reader.load_dump(str(tmp_path), f"{i:06d}_00")
        for k in FIELDS:
            want = s[k] if k != "P" else np.vstack([s["P"], [[0, 0, 0, 1]]])
            np.testing.assert_array_equal(d[k], np.asarray(want, d[k].dtype))
    other = tmp_path / "other"
    other.mkdir()
    for i, s in enumerate(samples):
        reader.save_sample_dump(str(other), f"{i:06d}_00", **s)
    for f in sorted(os.listdir(other)):
        assert (other / f).read_bytes() == (tmp_path / f).read_bytes(), f


def test_generate_labels_matches_jax():
    """Coarse and fine labels equal; pixel coordinates and depth within
    1e-5 relative (plus 1e-3 px absolute near 0): the products' f32 sums
    run in another order than the JAX einsums'."""
    cfg = config.kitti(input_pt_num=4096, batch_size=2,
                       synthetic_scene="street")
    b = synthetic_batch(cfg, seed=1)
    lt = generate_labels(*(torch.from_numpy(b[k]) for k in ("pc", "P", "K")),
                         cfg.img_H, cfg.img_W, cfg.img_fine_resolution_scale)
    lj = jax_labels(*(jnp.asarray(b[k]) for k in ("pc", "P", "K")),
                    cfg.img_H, cfg.img_W, cfg.img_fine_resolution_scale)
    np.testing.assert_array_equal(lt.coarse.numpy(), np.asarray(lj.coarse))
    np.testing.assert_array_equal(lt.fine.numpy(), np.asarray(lj.fine))
    np.testing.assert_allclose(lt.pxpy.numpy(), np.asarray(lj.pxpy),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(lt.z.numpy(), np.asarray(lj.z), rtol=1e-5)
    assert int(lt.fine_violations) == int(lj.fine_violations)
    assert lt.coarse.sum() > 0


def test_pseudo_clouds_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    depth = rng.uniform(3, 40, (H, W)).astype(np.float32)
    items = [("000000_00", np.zeros((H, W, 3), np.uint8))]
    kw = dict(stride=4, max_depth=35.0)
    n_t = dump_pseudo_pointclouds(items, K_np, lambda img: depth,
                                  str(tmp_path / "t"), device="cpu", **kw)
    n_j = jax_pseudo(items, K_np, lambda img: depth, str(tmp_path / "j"),
                     **kw)
    assert n_t == n_j == 1
    pt = np.load(tmp_path / "t" / "000000_00_pc.npy")
    pj = np.load(tmp_path / "j" / "000000_00_pc.npy")
    assert pt.shape == pj.shape and pt.shape[0] == 3
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-5)


def test_metrics_and_enu2cam_match_jax():
    rng = np.random.default_rng(3)
    P1 = np.eye(4)
    P1[:3, 3] = rng.normal(size=3)
    P2 = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    P2[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    assert pose_diff_np(P1, P2) == jax_pose_diff_np(P1, P2)
    pc = rng.normal(size=(10, 3))
    for a, b in zip(enu2cam(pc, P1), jax_enu2cam(pc, P1)):
        np.testing.assert_array_equal(a, b)


def test_random_method_matches_jax(tmp_path):
    """The same numpy draws for the same seed: the same summary."""
    rng = np.random.default_rng(4)
    for i in range(5):
        tdump.save_sample_dump(str(tmp_path), f"{i:06d}_00", **_sample(rng))
    for seed in (0, 3):
        kw = dict(method="random", H=H, W=W, seed=seed)
        np.testing.assert_equal(      # NaN equals NaN here
            evaluate_registration(str(tmp_path), device="cpu", **kw),
            jax_eval(str(tmp_path), **kw))


def _pnp_dumps(out, rng):
    """test_register_extra.py::test_dump_roundtrip_and_harness's data."""
    for i in range(3):
        pc, coarse, fine, P_gt = _pnp_problem(
            rng, yaw=rng.uniform(-1, 1),
            t=(rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)))
        jdump.save_sample_dump(out, f"{i:06d}_00", pc=pc, coarse_pred=coarse,
                               coarse_label=coarse, fine_pred=fine,
                               fine_label=fine, K=K_np, P=P_gt[:3])


def test_frustum_harness_on_the_jax_tests_problem(tmp_path):
    """The JAX test's frustum run (3 pairs, 8 inits, 32 iterations, GT
    labels): the same success rate as the JAX harness on the same dump.
    The inits are torch's draws, not jax.random's."""
    _pnp_dumps(str(tmp_path), np.random.default_rng(5))
    kw = dict(method="frustum", H=H, W=W, n_inits=8, max_iter=32,
              batch_size=3)
    s_t = evaluate_registration(str(tmp_path), use_labels=True,
                                device="cpu", **kw)
    s_j = jax_eval(str(tmp_path), use_labels=True, **kw)
    assert s_t["num_pairs"] == s_j["num_pairs"] == 3
    assert s_t["success_rate"] == s_j["success_rate"]
    assert s_t["success_rate"] >= 1.0 / 3.0


def test_harness_options_and_refusals(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(2):
        s = _sample(rng)
        tdump.save_sample_dump(str(tmp_path), f"{i:06d}_00", **s)
        np.save(tmp_path / f"{i:06d}_00_p.npy",
                rng.uniform(0, 1, 300).astype(np.float32))
    kw = dict(H=H, W=W, n_inits=8, max_iter=4, device="cpu")
    save = tmp_path / "save"
    summ = evaluate_registration(str(tmp_path), inside_threshold=0.3,
                                 confidence_gamma=1.0, save_dir=str(save),
                                 **kw)
    assert summ["num_pairs"] == 2 and np.isfinite(summ["rte_mean"])
    for f in ("P_pred_all_np.npy", "P_gt_all_np.npy", "cost_all_np.npy"):
        assert (save / f).is_file()
    assert np.isfinite(evaluate_registration(str(tmp_path), enu2cam=True,
                                             **kw)["rre_mean"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        evaluate_registration(str(tmp_path), method="pnp", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_registration(str(tmp_path), H=H, W=W)


def test_dump_predictions_with_the_port_detector(tmp_path):
    """dump_predictions drives the port's detector (config.tiny(), f32, on
    the CPU): argmax coarse and fine decisions, labels of the true pose,
    files the JAX package loads; save_probs / save_images /
    inside_threshold as in the JAX package."""
    cfg = config.tiny()
    raw = synthetic_batch(cfg, seed=8)
    model = build_detector(cfg, device="cpu", seed=0)
    acc = tdump.dump_predictions(model, [raw, raw], cfg, str(tmp_path),
                                 max_batches=1, save_images=True,
                                 save_probs=True)
    assert 0.0 <= acc[0] <= 1.0 and 0.0 <= acc[1] <= 1.0
    prefixes = jdump.list_dump_prefixes(str(tmp_path))
    assert prefixes == ["000000_00", "000001_00"]
    with torch.no_grad():
        coarse, fine = model(*(torch.from_numpy(raw[k]) for k in
                               tdump.INPUT_KEYS))
    lab = jax_labels(*(jnp.asarray(raw[k]) for k in ("pc", "P", "K")),
                     cfg.img_H, cfg.img_W, cfg.img_fine_resolution_scale)
    p_in = torch.softmax(coarse, -1)[..., 1].numpy()
    for b, prefix in enumerate(prefixes):
        d = jdump.load_dump(str(tmp_path), prefix)
        np.testing.assert_array_equal(d["coarse_pred"], p_in[b] > 0.5)
        np.testing.assert_array_equal(d["fine_pred"],
                                      fine[b].argmax(-1).numpy())
        np.testing.assert_array_equal(d["coarse_label"],
                                      np.asarray(lab.coarse[b]))
        np.testing.assert_array_equal(d["fine_label"],
                                      np.asarray(lab.fine[b]))
        np.testing.assert_allclose(d["p_inside"], p_in[b], rtol=1e-6)
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{prefix}_img.npy"), raw["img"][b])
    thr = tmp_path / "thr"
    tdump.dump_predictions(model, [raw], cfg, str(thr), inside_threshold=0.9)
    d = jdump.load_dump(str(thr), "000000_00")
    np.testing.assert_array_equal(d["coarse_pred"], p_in[0] > 0.9)
    plain = tmp_path / "plain"
    tdump.dump_predictions(model, [raw], cfg, str(plain))
    d = jdump.load_dump(str(plain), "000001_00")
    np.testing.assert_array_equal(d["coarse_pred"],
                                  coarse[1].argmax(-1).numpy())


def test_solve_cli_runs_on_the_cpu(tmp_path):
    _pnp_dumps(str(tmp_path), np.random.default_rng(9))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "deepi2p_tpu_torch.eval.cli", "solve",
         "--data-dir", str(tmp_path), "--method", "frustum", "--img-h",
         str(H), "--img-w", str(W), "--n-inits", "8", "--max-iter", "8",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    summ = json.loads(out.stdout)
    assert summ["num_pairs"] == 3 and np.isfinite(summ["rte_mean"])
