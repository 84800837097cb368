"""The port's ``eval.cli dump`` against the JAX package's dump on one
JAX-exported ``.npz`` at the tiny config: the ``pc``/``K``/``P`` contents
and the label rows equal, the predictions equal at the rate stated, with
and without ``--classify-n``; the refusals of what is not ported; and the
port's ``solve --method pnp --device cpu`` over the port's dump."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data import BatchLoader as JaxBatchLoader
from deepi2p_tpu.data import SyntheticDataset as JaxSyntheticDataset
from deepi2p_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from deepi2p_tpu.eval.dump import SubsampleEnsemble as JaxEnsemble
from deepi2p_tpu.eval.dump import dump_predictions as jax_dump_predictions
from deepi2p_tpu.train.checkpoint import export_npz
from deepi2p_tpu.train.engine import Engine as JaxEngine, TrainState
from deepi2p_tpu_torch.eval.cli import main as port_cli
from deepi2p_tpu_torch.models import INPUT_KEYS

from test_torch_port_checkpoint import interpret_knn, random_state

REPO = Path(__file__).resolve().parents[1]
DUMP_LEN = 4
PRED_RATE = 0.999


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = jconfig.tiny()
    batch = jax_synthetic_batch(cfg, seed=11)
    with interpret_knn():
        params, stats = random_state(
            JaxEngine(cfg).model, [jnp.asarray(batch[k]) for k in INPUT_KEYS],
            seed=5)
    state = TrainState(step=jnp.asarray(9, jnp.int32), params=params,
                       batch_stats=stats, opt_state=None)
    path = tmp_path_factory.mktemp("w") / "tiny.npz"
    export_npz(state, str(path))
    return str(path), state


def _jax_dump(state, out, classify_n=0, repeats=1):
    """What the JAX ``eval.cli dump --dataset synthetic`` does after it
    loads the checkpoint (its ``init_state`` compile alone takes ~30 s on
    one core): dataset seed 7, batches in order, the engine or the subset
    ensemble (seed 0) at ``classify_n`` points."""
    cfg = jconfig.tiny()
    loader = JaxBatchLoader(JaxSyntheticDataset(cfg, length=DUMP_LEN, seed=7),
                            cfg.batch_size, shuffle=False, num_workers=1)
    engine = JaxEngine(cfg.replace(input_pt_num=classify_n) if classify_n
                       else cfg)
    if classify_n:
        engine = JaxEnsemble(engine, seed=0, repeats=repeats)
    with interpret_knn():
        return jax_dump_predictions(engine, state, iter(loader), cfg, out)


@pytest.mark.parametrize("classify", [(), ("--classify-n", "96",
                                           "--classify-repeats", "2")])
def test_dump_matches_jax_dump(weights, tmp_path, capsys, classify):
    npz, state = weights
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_cli(["dump", "--out", str(port_dir), "--checkpoint", npz,
              "--dump-len", str(DUMP_LEN), "--device", "cpu", *classify])
    acc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    acc_j = _jax_dump(state, str(jax_dir),
                      *((96, 2) if classify else ()))
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    assert len(names) == 3 * DUMP_LEN
    agree = []
    for name in names:
        a, b = np.load(port_dir / name), np.load(jax_dir / name)
        if not name.endswith("_pc_label.npy"):
            assert (port_dir / name).read_bytes() == (jax_dir /
                                                      name).read_bytes()
            continue
        # rows: xyz, coarse_pred, coarse_label, fine_pred, fine_label
        np.testing.assert_array_equal(a[[0, 1, 2, 4, 6]], b[[0, 1, 2, 4, 6]])
        agree += [np.mean(a[3] == b[3]), np.mean(a[5] == b[5])]
    print(f"prediction agreement {min(agree):.5f}")
    assert min(agree) >= PRED_RATE, agree
    np.testing.assert_allclose([acc["coarse_accuracy"], acc["fine_accuracy"]],
                               acc_j, rtol=0, atol=1e-3)


def test_dump_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(SystemExit, match="needs --dataroot"):
        port_cli(["dump", "--out", str(tmp_path), "--dataset", "kitti",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="train.cli writes latest.npz"):
        port_cli(["dump", "--out", str(tmp_path), "--checkpoint",
                  str(tmp_path), "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli(["dump", "--out", str(tmp_path / "d")])


def test_solve_pnp_cli_runs_on_the_cpu_over_a_port_dump(weights, tmp_path,
                                                       capsys):
    port_cli(["dump", "--out", str(tmp_path), "--checkpoint", weights[0],
              "--dump-len", str(DUMP_LEN), "--device", "cpu",
              "--save-probs"])
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = ["solve", "--data-dir", str(tmp_path), "--method", "pnp",
            "--img-h", "64", "--img-w", "96", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "deepi2p_tpu_torch.eval.cli",
                          *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for summ in (json.loads(out.stdout), port_cli(args + ["--use-labels"])):
        assert summ["num_pairs"] == DUMP_LEN
        assert np.isfinite(summ["rte_mean"]) and np.isfinite(summ["rre_mean"])
