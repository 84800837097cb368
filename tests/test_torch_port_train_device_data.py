"""``python -m deepi2p_tpu_torch.train.cli --dataset synthetic
--device-data`` on the CPU (``config.tiny``): batches made by
``synthetic_batch_device`` from generators seeded per (epoch, step), none
through the ``BatchLoader``; finite losses; the same validation batches
every epoch; K steps per call on stacks of those batches; and the
refusals that remain."""
import numpy as np
import pytest
import torch

from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.train import cli
from deepi2p_tpu_torch.train.engine import Engine
from test_torch_port_train_parts import one_torch_thread  # noqa: F401
from torch_port_fixtures import tmp_path  # noqa: F401


def _run(tmp_path, *extra):
    return cli.main(["--dataset", "synthetic", "--device", "cpu",
                     "--device-data", "--checkpoints-dir",
                     str(tmp_path / "ck"), "--log-dir", str(tmp_path / "log"),
                     "--synthetic-len", "4", "--val-len", "4",
                     "--log-every", "1", *extra])


def test_device_data_trains_and_validates(tmp_path, monkeypatch, capsys):
    """Two epochs of two steps (tiny: B=2, 4 samples): every batch from
    the device generator, finite losses, validation on the same two
    batches in both epochs, and no BatchLoader."""
    def refuse(*a, **k):
        raise AssertionError("a --device-data batch went through the "
                             "BatchLoader")
    monkeypatch.setattr(cli, "BatchLoader", refuse)
    monkeypatch.setattr(cli, "device_prefetch", refuse)
    made, seen, losses = [], [], []
    batches = cli.device_batches

    def recording(cfg, device, seeds):
        seeds = list(seeds)
        made.extend(seeds)
        yield from batches(cfg, device, seeds)

    monkeypatch.setattr(cli, "device_batches", recording)
    train_step, eval_step = Engine.train_step, Engine.eval_step

    def train_rec(self, state, batch, gen):
        state, metrics = train_step(self, state, batch, gen)
        losses.append(float(metrics["loss"]))
        return state, metrics

    def eval_rec(self, state, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return eval_step(self, state, batch)
    monkeypatch.setattr(Engine, "train_step", train_rec)
    monkeypatch.setattr(Engine, "eval_step", eval_rec)

    state = _run(tmp_path, "--epochs", "2", "--seed", "3")
    assert state.step == 4
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert made == [(424245, 0, 0), (424245, 0, 1), (31340, 0), (31340, 1),
                    (424245, 1, 0), (424245, 1, 1), (31340, 0), (31340, 1)]
    assert len(seen) == 4
    for a, b in zip(seen[:2], seen[2:]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(seen[0]["pc"], seen[1]["pc"])
    out = capsys.readouterr().out
    assert "epoch 1 VAL" in out and (tmp_path / "ck" / "latest.npz").exists()


def test_device_seed_is_a_seed_sequence():
    assert cli.device_seed(424242, 0, 0) == int(
        np.random.SeedSequence([424242, 0, 0]).generate_state(1)[0])
    seeds = {cli.device_seed(424242, e, i) for e in range(4)
             for i in range(64)} | {cli.device_seed(31337, i)
                                    for i in range(64)}
    assert len(seeds) == 4 * 64 + 64
    g = torch.Generator().manual_seed(cli.device_seed(1, 2, 3))
    assert g.initial_seed() == cli.device_seed(1, 2, 3)


def test_device_batches_are_the_seeded_generators():
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data.synthetic_device import (
        synthetic_batch_device)
    cfg = config.tiny()
    got = list(cli.device_batches(cfg, torch.device("cpu"), [(7, 1, 2)]))
    want = synthetic_batch_device(
        cfg, torch.Generator().manual_seed(cli.device_seed(7, 1, 2)))
    for k in want:
        assert torch.equal(got[0][k], want[k]), k


def test_device_data_k_steps_per_call(tmp_path, monkeypatch):
    """``--steps-per-dispatch 2``, once refused: one call on a (2, B, ...)
    stack of the two batches a K = 1 epoch makes, from the same seeds."""
    made, seen = [], []
    batches = cli.device_batches

    def recording(cfg, device, seeds, k=1):
        seeds = list(seeds)
        made.append((seeds, k))
        yield from batches(cfg, device, seeds, k)

    scan = Engine.train_step_scan

    def scan_rec(self, state, stack, gen):
        seen.append({k: v.clone() for k, v in stack.items()})
        return scan(self, state, stack, gen)
    monkeypatch.setattr(cli, "device_batches", recording)
    monkeypatch.setattr(Engine, "train_step_scan", scan_rec)
    state = _run(tmp_path, "--epochs", "1", "--seed", "3",
                 "--steps-per-dispatch", "2")
    assert state.step == 2
    assert made == [([(424245, 0, 0), (424245, 0, 1)], 2),
                    ([(31340, 0), (31340, 1)], 1)]
    assert len(seen) == 1 and tuple(seen[0]["pc"].shape[:2]) == (2, 2)
    for i, step in enumerate(batches(config.tiny(), torch.device("cpu"),
                                     made[0][0])):
        for k, v in step.items():
            assert torch.equal(seen[0][k][i], v), k


@pytest.mark.parametrize("flags,message", [
    (("--mesh-model", "2"), "--mesh-model 2 needs a world size that is a "
                            "multiple of it"),
    (("--dataset", "kitti", "--dataroot", "/nonexistent"),
     "--device-data requires --dataset synthetic"),
])
def test_device_data_refusals(tmp_path, flags, message):
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, *flags)
    assert message in str(e.value.code)
    assert not (tmp_path / "ck").exists()
