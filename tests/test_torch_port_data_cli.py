"""The port's CLIs on a fake KITTI tree, on the CPU: ``train.cli
--dataset kitti`` takes its steps through the threaded loader and the
prefetch and writes its checkpoints; ``eval.cli dump --dataset kitti``
writes a dump whose ``pc``, ``P`` and ``K`` are the JAX ``KittiLoader``'s
samples in ``val_random_Ry`` (one worker, the same call order), with the
port's native core loaded into the JAX package for its node sampling."""
import json
import shutil

import numpy as np
import pytest
import torch

import deepi2p_tpu.data.native as jax_native
from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import KittiLoader as JaxKitti
from deepi2p_tpu_torch.data import native as port_native
from deepi2p_tpu_torch.eval import cli as eval_cli
from deepi2p_tpu_torch.eval.dump import list_dump_prefixes, load_dump
from deepi2p_tpu_torch.train import cli as train_cli
from torch_port_data_trees import kitti_tree
from torch_port_fixtures import tmp_path  # noqa: F401

# the KITTI preset cut to a tiny size (the fake tree's images are 200x300)
SMALL = ["--points", "256", "--nodes", "16", "--img-h", "64",
         "--img-w", "128", "--batch-size", "2"]


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native core cannot be built")
    base = tmp_path_factory.mktemp("data")
    yield kitti_tree(base / "kitti", np.random.default_rng(0),
                     seqs=("00", "09"), img_dtype=np.uint8)
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_cli_on_kitti(kitti, tmp_path, capsys):
    ck = tmp_path / "ck"
    state = train_cli.main(
        ["--dataset", "kitti", "--dataroot", kitti, "--device", "cpu",
         "--workers", "3", "--epochs", "1", "--log-every", "1",
         "--checkpoints-dir", str(ck), "--log-dir", str(tmp_path / "log"),
         *SMALL])
    out = capsys.readouterr().out
    # 12 train samples in batches of 2, 12 val samples
    assert state.step == 6
    assert "epoch 0 step 6:" in out and "epoch 0 VAL:" in out
    assert (ck / "latest.npz").exists()
    lines = [json.loads(x) for x in (tmp_path / "log" / "metrics.jsonl")
             .read_text().splitlines()]
    losses = [x["loss"] for x in lines if x.get("tag") == "train"]
    assert len(losses) == 6 and np.isfinite(losses).all()


def test_train_cli_needs_a_dataroot(tmp_path):
    with pytest.raises(SystemExit, match="needs --dataroot"):
        train_cli.main(["--dataset", "oxford", "--device", "cpu",
                        "--checkpoints-dir", str(tmp_path)])


def test_eval_dump_on_kitti_matches_jax_loader(kitti, tmp_path, capsys,
                                               monkeypatch):
    out = tmp_path / "dump"
    eval_cli.main(["dump", "--dataset", "kitti", "--dataroot", kitti,
                   "--device", "cpu", "--out", str(out), "--max-batches",
                   "3", *SMALL])
    acc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0 <= acc["coarse_accuracy"] <= 1
    monkeypatch.setenv("DEEPI2P_NATIVE_LIB", str(port_native.build()))
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    cfg = jax_config.kitti(input_pt_num=256, node_a_num=16, node_b_num=16,
                           k_ab=16, img_H=64, img_W=128, batch_size=2)
    ld = JaxKitti(kitti, "val", cfg)
    ld.mode = "val_random_Ry"
    prefixes = list_dump_prefixes(str(out))
    assert len(prefixes) == 6
    for i, prefix in enumerate(prefixes):
        dump, want = load_dump(str(out), prefix), ld[i]
        dump["P"] = dump["P"][:3]          # the dump keeps the 4x4 pose
        for k in ("pc", "P", "K"):
            np.testing.assert_array_equal(dump[k].astype(np.float64),
                                          want[k].astype(np.float64),
                                          err_msg=k)
