"""The port's trainer on the CPU: the shuffled loader and the fresh-scene
dataset against the JAX package's, ``python -m
deepi2p_tpu_torch.train.cli --dataset synthetic`` (tiny preset) training,
validating, checkpointing and resuming, a ``--mesh-model`` the world
cannot hold refused, K steps per call (``--steps-per-dispatch``; more in
``test_torch_port_train_scan_cli.py``), its ``latest.npz`` read by the
port's ``eval.cli dump``, the ``MMClassifier`` facade (as
``tests/test_classifier_facade.py`` drives the JAX one) and the metrics
logger."""
import json
import os
import struct

import numpy as np
import pytest
import torch

from deepi2p_tpu import config as jconfig
from deepi2p_tpu.data import BatchLoader as JaxBatchLoader
from deepi2p_tpu.data import SyntheticDataset as JaxSyntheticDataset
from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.data import BatchLoader, SyntheticDataset
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.eval import cli as eval_cli
from deepi2p_tpu_torch.train import cli
from deepi2p_tpu_torch.train.classifier import MMClassifier
from deepi2p_tpu_torch.utils.logging import MetricsLogger
from test_torch_port_train_parts import one_torch_thread  # noqa: F401
from torch_port_fixtures import tmp_path  # noqa: F401


@pytest.mark.parametrize("shuffle,seed", [(True, 11), (True, 12),
                                          (False, 11)])
def test_loader_order_and_fresh_scenes_match_jax(shuffle, seed):
    """Seven fresh-scene samples at epoch 3, batches of 2: the same
    batches, in the same order, as the JAX ``BatchLoader`` (one worker)
    over the JAX ``SyntheticDataset``; the last partial batch dropped."""
    ds_t = SyntheticDataset(tconfig.tiny(), length=7, seed=2, fresh=True)
    ds_j = JaxSyntheticDataset(jconfig.tiny(), length=7, seed=2, fresh=True)
    for ds in (ds_t, ds_j):
        ds.set_epoch(3)
    kw = dict(shuffle=shuffle, seed=seed)
    got = list(BatchLoader(ds_t, 2, **kw))
    want = list(JaxBatchLoader(ds_j, 2, num_workers=1, **kw))
    assert len(got) == len(want) == len(BatchLoader(ds_t, 2, **kw))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # not fresh: set_epoch leaves the scenes alone
    plain = SyntheticDataset(tconfig.tiny(), length=7, seed=2)
    plain.set_epoch(3)
    np.testing.assert_array_equal(plain[1]["pc"], SyntheticDataset(
        tconfig.tiny(), length=7, seed=2)[1]["pc"])
    assert not np.array_equal(plain[1]["pc"], ds_t[1]["pc"])


def _run(tmp_path, *extra):
    return cli.main(["--dataset", "synthetic", "--device", "cpu",
                     "--checkpoints-dir", str(tmp_path / "ck"),
                     "--log-dir", str(tmp_path / "log"),
                     "--log-every", "1", *extra])


def test_cli_trains_validates_checkpoints_and_dumps(tmp_path, capsys):
    """Two epochs of 2 steps (tiny preset): a checkpoint per epoch and
    ``latest.npz``; train and validation scalars in ``metrics.jsonl``;
    ``latest.npz`` read by the port's ``eval.cli dump``."""
    state = _run(tmp_path, "--synthetic-len", "4", "--val-len", "2",
                 "--epochs", "2")
    assert state.step == 4
    ck = tmp_path / "ck"
    assert sorted(os.listdir(ck)) == ["ckpt_2.pt", "ckpt_4.pt", "latest.npz"]
    out = capsys.readouterr().out
    assert "epoch 1 VAL: " in out and "epoch 1 done" in out
    recs = [json.loads(line) for line in
            open(tmp_path / "log" / "metrics.jsonl")]
    assert [r["tag"] for r in recs].count("train") == 4
    assert [r["step"] for r in recs if r["tag"] == "val"] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)
    acc = eval_cli.main(["dump", "--checkpoint", str(ck / "latest.npz"),
                         "--out", str(tmp_path / "dump"), "--dump-len", "2",
                         "--device", "cpu"])
    assert 0.0 <= acc["coarse_accuracy"] <= 1.0
    assert len(os.listdir(tmp_path / "dump")) > 0


def test_cli_resume_floors_to_the_epoch(tmp_path, capsys):
    """An epoch of 3 steps with a checkpoint every 2: with the epoch-end
    checkpoint gone (a run killed after step 2), ``--resume`` restores
    step 2, floors it to 0 and runs both epochs again; from the epoch-end
    checkpoint it runs only the second.  A ``--warm-start`` beside a
    resumable checkpoint is skipped."""
    args = ("--synthetic-len", "6", "--val-len", "2")
    _run(tmp_path, *args, "--epochs", "1", "--ckpt-every", "2")
    ck = tmp_path / "ck"
    assert sorted(f for f in os.listdir(ck) if f.endswith(".pt")) == [
        "ckpt_2.pt", "ckpt_3.pt"]
    os.replace(ck / "ckpt_3.pt", tmp_path / "ckpt_3.pt")
    capsys.readouterr()
    state = _run(tmp_path, *args, "--epochs", "1", "--resume",
                 "--warm-start", str(ck / "latest.npz"))
    out = capsys.readouterr().out
    assert "warm-start SKIPPED" in out
    assert "resumed at step 2 (epoch 0; step floored to 0)" in out
    assert state.step == 3
    state = _run(tmp_path, *args, "--epochs", "2", "--resume")
    out = capsys.readouterr().out
    assert "resumed at step 3 (epoch 1)" in out and "epoch 0 " not in out
    assert state.step == 6


@pytest.mark.parametrize("flags,says", [
    (("--mesh-model", "4"), "--mesh-model 4 needs a world size that is a "
                            "multiple of it; the world has 1 rank(s)"),
    (("--mesh-model", "2"), "--mesh-model 2 needs a world size that is a "
                            "multiple of it; the world has 1 rank(s)"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, flags, says):
    """What the port refuses: a ``--mesh-model`` the world size is not a
    multiple of (one rank here)."""
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, *flags)
    assert says in str(e.value.code)
    assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("flags,calls", [
    (("--steps-per-dispatch", "2"), 2),
    (("--device-data", "--steps-per-dispatch", "2"), 2),
    (("--steps-per-dispatch", "4"), 1),
])
def test_cli_takes_k_steps_per_call(tmp_path, monkeypatch, flags, calls):
    """A K-step dispatch, once refused, runs at the JAX
    ``test_cli.py::test_train_cli_steps_per_dispatch`` settings (8
    samples, batches of 2, one worker): ``calls`` calls of
    ``train_step_scan`` on (K, 2, ...) stacks, no single step, step 4, a
    log line per call."""
    from deepi2p_tpu_torch.train.engine import Engine
    seen = []
    scan = Engine.train_step_scan

    def recorded(self, state, batches, gen):
        seen.append(tuple(batches["pc"].shape[:2]))
        return scan(self, state, batches, gen)

    def refuse(*a, **k):
        raise AssertionError("a single step in a K-step run")
    monkeypatch.setattr(Engine, "train_step_scan", recorded)
    monkeypatch.setattr(Engine, "train_step", refuse)
    state = _run(tmp_path, *flags, "--synthetic-len", "8", "--val-len", "2",
                 "--epochs", "1", "--workers", "1")
    K = 4 // calls
    assert state.step == 4 and seen == [(K, 2)] * calls
    recs = [json.loads(line) for line in
            open(tmp_path / "log" / "metrics.jsonl")]
    assert [(r["tag"], r["step"]) for r in recs] == [
        *(("train", K * (i + 1)) for i in range(calls)), ("val", 4)]


def test_classifier_facade(tmp_path):
    """The reference engine API on the port's engine (CPU)."""
    cfg = tconfig.tiny()
    clf = MMClassifier(cfg, steps_per_epoch=10, log_dir=str(tmp_path / "log"),
                       device="cpu")
    clf.set_input(synthetic_batch(cfg, seed=0))
    m1 = clf.optimize()
    assert np.isfinite(m1["loss"]) and clf.global_step == 1
    m2 = clf.test_model()
    assert "coarse_accuracy" in m2
    coarse, fine = clf.inference_pass()
    assert coarse.shape == (cfg.batch_size, cfg.input_pt_num)
    train_err, _ = clf.get_current_errors()
    assert train_err["loss"] == m1["loss"]
    acc_tr, _ = clf.get_current_accuracy()
    assert set(acc_tr) == {"coarse_accuracy", "fine_accuracy"}
    assert 0 < clf.update_learning_rate(0.5) <= cfg.lr * 1.001
    ckdir = str(tmp_path / "ck")
    clf.save_network(ckdir)
    saved = {k: v.clone() for k, v in clf.state.model.state_dict().items()}
    clf.optimize()
    clf.load_model(ckdir)
    assert clf.global_step == 1
    assert all(torch.equal(v, saved[k])
               for k, v in clf.state.model.state_dict().items())
    sd = {"module." + k: v for k, v in saved.items()}
    sd["module.img_encoder.backbone.bn1.num_batches_tracked"] = torch.tensor(3)
    clf.load_torch_checkpoint(sd)


def _events(path):
    """The ``Event`` records of a TensorBoard event file (uint64 length,
    uint32 CRC, data, uint32 CRC each)."""
    from tensorboard.compat.proto.event_pb2 import Event
    data, out, at = open(path, "rb").read(), [], 0
    while at < len(data):
        n = struct.unpack("<Q", data[at:at + 8])[0]
        out.append(Event.FromString(data[at + 12:at + 12 + n]))
        at += 16 + n
    return out


def test_metrics_logger_jsonl_and_tensorboard_sink(tmp_path):
    """Scalars go to ``metrics.jsonl`` and to a TensorBoard event file,
    each value as ``tag/name`` at its step."""
    log = MetricsLogger(str(tmp_path))
    log.log_scalars("train", {"loss": torch.tensor(2.5), "lr": 1e-3}, 7)
    log.close()
    MetricsLogger(str(tmp_path)).close()
    rec = json.loads(open(tmp_path / "metrics.jsonl").readline())
    assert rec["tag"] == "train" and rec["step"] == 7 and rec["loss"] == 2.5
    files = sorted(tmp_path.glob("events.out.tfevents.*"))
    assert len(files) == 2
    first = _events(files[0])
    assert first[0].file_version == "brain.Event:2" and len(first) == 2
    assert first[1].step == 7 and [
        (v.tag, v.simple_value) for v in first[1].summary.value] == [
        ("train/loss", 2.5), ("train/lr", pytest.approx(1e-3))]