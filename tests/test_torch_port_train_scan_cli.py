"""``python -m deepi2p_tpu_torch.train.cli --steps-per-dispatch K`` on the
CPU (``config.tiny()``, batches of 2): the epoch rounded down to a
multiple of K with its message, ``--ckpt-every`` at call boundaries,
``--resume`` flooring with the rounded epoch, a K = 2 run bitwise a K = 1
run from the host loader and with ``--device-data``, and two gloo ranks
under ``torch.distributed.run`` against one.  ``Engine.train_step_scan`` itself
is held to JAX in ``tests/test_torch_port_train_scan.py``; the JAX
``test_cli.py``'s K-step run is ``test_torch_port_train_cli.py``'s
``test_cli_takes_k_steps_per_call``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deepi2p_tpu_torch.train import cli
from test_torch_port_train_scan import _bitwise, _snapshot
from torch_port_fixtures import one_torch_thread, tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, name, *extra):
    return cli.main(["--dataset", "synthetic", "--device", "cpu",
                     "--batch-size", "2", "--workers", "1",
                     "--checkpoints-dir", str(tmp_path / name / "ck"),
                     "--log-dir", str(tmp_path / name / "log"), *extra])


def _records(tmp_path, name):
    with open(tmp_path / name / "log" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_rounds_a_ragged_epoch_and_saves_at_calls(tmp_path, capsys):
    """14 samples, K = 2: 7 batches, an epoch of 6 steps; a save every 3
    steps falls at the first call boundary past it (step 4), then at the
    epoch's end (step 6)."""
    state = _run(tmp_path, "a", "--epochs", "1", "--synthetic-len", "14",
                 "--val-len", "2", "--log-every", "1", "--ckpt-every", "3",
                 "--steps-per-dispatch", "2")
    out = capsys.readouterr().out
    assert ("steps-per-dispatch 2: epoch rounded to 6 steps (1 ragged "
            "batches/epoch dropped)") in out
    assert state.step == 6
    assert [(r["tag"], r["step"]) for r in _records(tmp_path, "a")] == [
        ("train", 2), ("train", 4), ("train", 6), ("val", 6)]
    assert sorted(f for f in os.listdir(tmp_path / "a" / "ck")
                  if f.endswith(".pt")) == ["ckpt_4.pt", "ckpt_6.pt"]


def test_cli_resume_floors_with_the_rounded_epoch(tmp_path, capsys):
    """10 samples, K = 2: an epoch of 4 steps (5 unrounded).  Killed after
    the save at step 2, ``--resume`` floors to 0 and runs the epoch again;
    from the epoch's end (step 4) it is epoch 1, which the unrounded 5
    would have floored to 0."""
    args = ("--synthetic-len", "10", "--val-len", "2", "--log-every", "100",
            "--steps-per-dispatch", "2")
    _run(tmp_path, "a", *args, "--epochs", "1", "--ckpt-every", "2")
    ck = tmp_path / "a" / "ck"
    assert sorted(f for f in os.listdir(ck) if f.endswith(".pt")) == [
        "ckpt_2.pt", "ckpt_4.pt"]
    os.replace(ck / "ckpt_4.pt", tmp_path / "ckpt_4.pt")
    capsys.readouterr()
    state = _run(tmp_path, "a", *args, "--epochs", "1", "--resume")
    assert "resumed at step 2 (epoch 0; step floored to 0)" in \
        capsys.readouterr().out
    assert state.step == 4
    state = _run(tmp_path, "a", *args, "--epochs", "2", "--resume")
    out = capsys.readouterr().out
    assert "resumed at step 4 (epoch 1)" in out and "epoch 0 " not in out
    assert state.step == 8


@pytest.mark.parametrize("data", [(), ("--device-data",)],
                         ids=["host", "device"])
def test_cli_k2_is_the_k1_run_bitwise(tmp_path, data):
    """8 samples, batches of 2: K = 2 ends bitwise at the K = 1 run's
    state (parameters, statistics, Adam moments, step) and logs the same
    metrics at the steps both log."""
    flags = ("--epochs", "1", "--synthetic-len", "8", "--val-len", "2",
             "--log-every", "2", *data)
    one = _run(tmp_path, "k1", *flags)
    two = _run(tmp_path, "k2", *flags, "--steps-per-dispatch", "2")
    assert one.step == two.step == 4
    _bitwise(_snapshot(one, {}), _snapshot(two, {}))
    strip = [[{k: v for k, v in r.items() if k != "time"}
              for r in _records(tmp_path, name)] for name in ("k1", "k2")]
    assert strip[0] == strip[1] and len(strip[0]) == 3


def test_two_ranks_under_torch_distributed_run(tmp_path):
    """``--device-data --steps-per-dispatch 2`` over two gloo ranks: the
    one-rank run's logged steps, its loss at the call's last step within
    1e-3 (one Adam step before it, whose sign the sum order flips where a
    gradient is near 0; ``test_torch_port_parallel.py``), a finite
    validation loss, rank 0 alone writing."""
    flags = ["--dataset", "synthetic", "--device-data", "--device", "cpu",
             "--synthetic-len", "4", "--val-len", "2", "--epochs", "1",
             "--log-every", "1", "--steps-per-dispatch", "2"]
    one = cli.main([*flags, "--checkpoints-dir", str(tmp_path / "1" / "ck"),
                    "--log-dir", str(tmp_path / "1" / "log")])
    assert one.step == 2
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--log-dir", str(tmp_path / "tr"),
         "--tee", "3", "-m", "deepi2p_tpu_torch.train.cli", *flags,
         "--checkpoints-dir", str(tmp_path / "2" / "ck"),
         "--log-dir", str(tmp_path / "2" / "log")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 1} over 2 ranks" in res.stdout
    want, got = ([(r["tag"], r["step"], r["loss"])
                  for r in _records(tmp_path, name)]
                 for name in ("1", "2"))
    assert [w[:2] for w in want] == [g[:2] for g in got] == [
        ("train", 2), ("val", 2)]
    assert abs(got[0][2] - want[0][2]) <= 1e-3 * abs(want[0][2])
    assert np.isfinite(got[1][2])
    assert sorted(os.listdir(tmp_path / "2" / "ck")) == ["ckpt_2.pt",
                                                          "latest.npz"]
