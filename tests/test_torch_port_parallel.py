"""The port over several ranks (``deepi2p_tpu_torch/parallel``): gloo ranks
spawned on the CPU (``parallel/dryrun.py::launch``, a ``file://`` init
under ``tmp_path``), held to the single-process port and to the JAX
package:

* 2 ranks (DP) from the JAX train-step parity state
  (``test_torch_port_train_step.py``'s ``jax_step``, dropout off): loss and
  metrics within 1e-5 of the one-rank step and of the JAX ``Engine``'s,
  and those of the eval step from the same state within 1e-5 of one
  rank's;
  the float64 copy's gradient within 1e-8 of one rank's; parameters after
  the step bitwise equal across ranks; the running statistics within 1e-6
  of one rank's in the float64 copy and within the f32 parity tolerance
  (1e-5) in f32, and within it of the JAX step's;
* 4 ranks (2 x 2, TP): wide Linears split, a finite step, the train and
  eval steps' metrics as at 2 ranks, the float64 gradient within 1e-8 of
  one rank's; then the JAX dry run's point-axis sharding (the clouds'
  point axis split over the model ranks too): the eval loss equal to the
  DP layout's (JAX holds it within 1e-3), a train step from it to a
  finite loss, parameters bitwise equal across ranks;
* ``make_sharded_registration`` at 1, 2 and 4 ranks: bitwise equal inits,
  and poses and costs that match the JAX ``solve_frustum_batch`` fed the
  same inits, at the JAX dry run's bounds;
* ``train.cli`` under ``torch.distributed.run --nproc-per-node 2``: the
  one-rank run's losses, and rank 0 alone logs and writes.
"""
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.register.frustum import solve_frustum_batch as jax_solve
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data.synthetic import synthetic_batch
from deepi2p_tpu_torch.models import load_state_dict
from deepi2p_tpu_torch.models.from_jax import state_dict_from_flax
from deepi2p_tpu_torch.parallel import dryrun
from deepi2p_tpu_torch.parallel.mesh import make_mesh
from deepi2p_tpu_torch.train import cli
from deepi2p_tpu_torch.train.engine import Engine
from test_torch_port_train_step import (LOSS_RTOL, STATS_TOL,
                                        jax_step)  # noqa: F401
from torch_port_fixtures import one_torch_thread, tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """The 4-rank (seeded weights) and 2-rank (the JAX parity state)
    launches, the 4 ranks started before the JAX step compiles."""
    tmp = tmp_path_factory.mktemp("ranks")
    cfg = config.tiny()
    reg_batch = str(tmp / "reg.npz")
    np.savez(reg_batch, **synthetic_batch(cfg, N_PAIRS, seed=2))
    reg = {"batch": reg_batch}
    tp_batch = str(tmp / "tp.npz")
    np.savez(tp_batch, **synthetic_batch(cfg, seed=1))
    (tmp / "w4").mkdir()
    four = dryrun.start(4, {"train": {"n_model": 2, "batch": tp_batch},
                            "register": reg}, str(tmp / "w4"))
    jax_step = request.getfixturevalue("jax_step")
    state = Engine(cfg, device="cpu").init_state(seed=5)
    load_state_dict(state.model, state_dict_from_flax(jax_step["params"],
                                                      jax_step["stats"]))
    weights = str(tmp / "weights.pt")
    torch.save(state.model.state_dict(), weights)
    train_batch = str(tmp / "train.npz")
    np.savez(train_batch, **jax_step["batch"])
    (tmp / "w2").mkdir()
    dp = {"n_model": 1, "batch": train_batch, "weights": weights,
          "dropout": False}
    out = {2: dryrun.launch(2, {"train": dp, "register": reg},
                            str(tmp / "w2")),
           4: dryrun.wait(four)}
    out["ref_reg"] = dryrun.register_job(make_mesh(1), cfg, reg)
    out["reg_batch"] = dict(np.load(reg_batch))
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def test_dp_two_ranks_is_the_one_rank_step_and_jax(
        runs, jax_step):  # noqa: F811
    results = runs[2]
    assert results[0]["mesh"] == {"data": 2, "model": 1}
    read = dryrun.check_train(results, loss_rtol=LOSS_RTOL,
                              stats_rtol=STATS_TOL, stats64_rtol=1e-6)
    assert read["n_split"] == 0 and read["grad64_err"] <= 1e-8
    metrics = results[0]["train"]["metrics"]
    assert set(metrics) == set(jax_step["metrics"])
    for k, v in jax_step["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, atol=0,
                                   err_msg=k)
    got = results[0]["train"]["stats"]
    want = state_dict_from_flax(jax_step["params"], jax_step["new_stats"])
    assert len(got) > 20
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=k)


def test_tp_four_ranks_splits_and_is_the_one_rank_gradient(runs):
    results = runs[4]
    assert results[0]["mesh"] == {"data": 2, "model": 2}
    # at the seeded weights (not the parity state) the f32 statistics of
    # the later layers sit up to 1.7e-5 from one rank's; the float64
    # copy's within 1e-6
    read = dryrun.check_train(results, loss_rtol=LOSS_RTOL,
                              stats_rtol=1e-4, stats64_rtol=1e-6)
    assert read["n_split"] > 0
    assert read["grad64_err"] <= 1e-8
    assert np.isfinite(read["loss"])
    # the split leaves differ between model ranks before the gather
    assert all(r["train"]["n_split"] == read["n_split"] for r in results)


def test_tp_four_ranks_point_sharded_eval_and_step(runs):
    """``__graft_entry__.py:120-146`` on the 2 x 2 layout: each rank holds
    1 of the batch's 2 samples and 128 of its 256 points; the gathered
    forward is the DP layout's computation, so its eval loss is equal;
    the step from it is finite and leaves the replicas equal."""
    assert all("points" not in r["train"] for r in runs[2])
    pts = [r["train"]["points"] for r in runs[4]]
    read = dryrun.check_points(pts)
    cfg = config.tiny()
    assert all(p["points"] == (cfg.batch_size // 2, cfg.input_pt_num // 2,
                               3) for p in pts)
    assert read["eval_rel_diff"] == 0.0
    assert all(p["eval_loss"] == p["eval_loss_dp"] for p in pts)
    assert np.isfinite(read["loss"])


@pytest.mark.parametrize("mode", ["2d", "6dof"])
def test_sharded_registration_is_layout_free_and_the_jax_solve(runs, mode):
    ref = runs["ref_reg"][mode]
    for world in (2, 4):
        for r in runs[world]:
            got = r["register"][mode]
            assert torch.equal(got["theta0"], ref["theta0"]), world
            np.testing.assert_allclose(
                got["P"].numpy(), ref["P"].numpy(),
                **(dryrun.POSE_2D if mode == "2d" else dryrun.POSE_6D))
            np.testing.assert_allclose(got["cost"].numpy(),
                                       ref["cost"].numpy(), **dryrun.COST)
    cfg = config.tiny()
    b = runs["reg_batch"]
    model = dryrun.build_detector_for(cfg)
    with torch.no_grad():
        coarse, _ = model(*(torch.from_numpy(b[k])
                            for k in dryrun.INPUT_KEYS))
    pred = torch.argmax(coarse, -1).numpy()
    P_j, c_j = jax_solve(jnp.asarray(b["pc"]), jnp.asarray(pred),
                         jnp.asarray(b["K"]), H=cfg.img_H, W=cfg.img_W,
                         n_inits=8, max_iter=4, is_2d=mode == "2d",
                         theta0=jnp.asarray(ref["theta0"].numpy()))
    np.testing.assert_allclose(
        ref["P"].numpy(), np.asarray(P_j),
        **(dryrun.POSE_2D if mode == "2d" else dryrun.POSE_6D))
    np.testing.assert_allclose(ref["cost"].numpy(), np.asarray(c_j),
                               **dryrun.COST)


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["tag"], r["step"], r["loss"]) for r in recs]


def test_train_cli_under_torch_distributed_run(tmp_path, capsys):
    flags = ["--dataset", "synthetic", "--device-data", "--device", "cpu",
             "--synthetic-len", "4", "--val-len", "2", "--epochs", "1",
             "--log-every", "1"]
    one = cli.main([*flags, "--checkpoints-dir", str(tmp_path / "ck1"),
                    "--log-dir", str(tmp_path / "log1")])
    assert one.step == 2
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--log-dir", str(tmp_path / "tr"),
         "--tee", "3", "-m", "deepi2p_tpu_torch.train.cli", *flags,
         "--checkpoints-dir", str(tmp_path / "ck2"),
         "--log-dir", str(tmp_path / "log2")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 1} over 2 ranks" in res.stdout
    # rank 0 alone prints and logs: one record per step and epoch
    epoch_lines = [line for line in res.stdout.splitlines()
                   if "epoch 0 done" in line]
    assert len(epoch_lines) == 1
    want, got = _losses(tmp_path / "log1"), _losses(tmp_path / "log2")
    assert [w[:2] for w in want] == [g[:2] for g in got] == [
        ("train", 1), ("train", 2), ("val", 2)]
    # the first step's loss to f32 rounding; after it, the first Adam
    # step has moved each weight by ~lr * sign(gradient), whose sign the
    # sum order flips where a gradient is near 0: the second step's loss
    # 2.3e-4 apart, and the eval-mode validation after two steps from the
    # seeded statistics (a loss of ~1.5e5) 11%, so it is not compared
    assert abs(got[0][2] - want[0][2]) <= LOSS_RTOL * abs(want[0][2])
    assert abs(got[1][2] - want[1][2]) <= 1e-3 * abs(want[1][2])
    assert np.isfinite(got[2][2])
    assert sorted(os.listdir(tmp_path / "ck2")) == ["ckpt_2.pt",
                                                    "latest.npz"]
    # rank 0 wrote the single-process form (no parameter compared: the
    # first Adam steps move each weight by ~lr * sign(gradient), whose
    # sign the sum order flips where a gradient is near 0)
    a = np.load(tmp_path / "ck1" / "latest.npz")
    b = np.load(tmp_path / "ck2" / "latest.npz")
    assert a.files == b.files
    assert all(a[k].shape == b[k].shape for k in a.files)
    assert int(b["__step__"]) == 2
