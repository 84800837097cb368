"""The check catches a broken program: with the timed path broken
underneath (a step that leaves its state unchanged, half of the batch
left out, an answer altered where it is produced; in training also a step
that writes Adam's moments but not the parameters, and norms that keep
their running statistics) a run reads not correct; so does the control,
the reference at the next lower precision put in the program's place.
The ICP check compares a pair of every slot of the batch."""
import pytest
import torch

import deepi2p_tpu_torch.register as register
import deepi2p_tpu_torch.register.icp as icp
import deepi2p_tpu_torch.train.engine as engine
from deepi2p_tpu_torch.models.detector import KeypointDetector
from deepi2p_tpu_torch.models.layers import Norm
from deepi2p_tpu_torch.train.engine import Engine
from portbench.loops import icp as icp_loop
from portbench.tests.tiny import CELLS, run_tiny


def _solve_no_iterations(orig):
    def solve(*a, **kw):
        return orig(*a, **dict(kw, max_iter=0))
    return solve


def _solve_pose_moved(orig):
    def solve(*a, **kw):
        P, cost = orig(*a, **kw)
        P = P.clone()
        P[:, 0, 3] += 1.0
        return P, cost
    return solve


def _forward_half(orig):
    def forward(self, *inputs, **kw):
        coarse, fine = orig(self, *inputs, **kw)
        h = coarse.shape[0] // 2
        return (torch.cat([coarse[:h], coarse[:h]]),
                torch.cat([fine[:h], fine[:h]]))
    return forward


def _train_unchanged(self, state, grads):
    state.step += 1
    return 0.0


def _train_half(orig):
    def train_step(self, state, batch, generator):
        h = batch["pc"].shape[0] // 2
        return orig(self, state, {k: v[:h] for k, v in batch.items()},
                    generator)
    return train_step


def _adam_params_skipped(orig):
    def adam_update(params, *a, **kw):
        orig([p.detach().clone() for p in params], *a, **kw)
    return adam_update


def _norm_stats_frozen(orig):
    def forward(self, x):
        kept = [b.clone() for b in self.buffers()]
        y = orig(self, x)
        with torch.no_grad():
            for b, k in zip(self.buffers(), kept):
                b.copy_(k)
        return y
    return forward


def _icp_no_iterations(orig):
    def icp_batch(*a, **kw):
        return orig(*a, **dict(kw, max_iter=0))
    return icp_batch


def _icp_half(orig):
    def icp_batch(source, target, gen, **kw):
        h = source.shape[0] // 2
        res = orig(source[:h], target[:h], gen, **kw)
        return icp.ICPResult(P=torch.cat([res.P, res.P]),
                             fitness=torch.cat([res.fitness, res.fitness]))
    return icp_batch


def _icp_pose_moved(orig):
    def icp_batch(*a, **kw):
        res = orig(*a, **kw)
        P = res.P.clone()
        P[:, 2, 3] += 1.0
        return icp.ICPResult(P=P, fitness=res.fitness)
    return icp_batch


FAULTS = {
    "oxford.register": {
        "unchanged": (register, "solve_frustum_batch", _solve_no_iterations),
        "half": (KeypointDetector, "forward", _forward_half),
        "altered": (register, "solve_frustum_batch", _solve_pose_moved)},
    "kitti.train": {
        "unchanged": (Engine, "apply_gradients", lambda orig:
                      _train_unchanged),
        "half": (Engine, "train_step", _train_half),
        "params_skipped": (engine, "adam_update", _adam_params_skipped),
        "stats_frozen": (Norm, "forward", _norm_stats_frozen)},
    "kitti.icp": {
        "unchanged": (icp, "icp_batch", _icp_no_iterations),
        "half": (icp, "icp_batch", _icp_half),
        "altered": (icp, "icp_batch", _icp_pose_moved)},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    owner, name, make = FAULTS[cell][fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    result, checks = run_tiny(cell)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    result, checks = run_tiny(cell, controls=("control",))
    assert result["correct"] is True, checks
    control = result["readings"]["control"]
    assert any(control[k] > lim for k, (_, lim) in checks.items()), control


@pytest.mark.parametrize("batches", [list(range(3, 13)), [5, 9]])
def test_the_icp_check_compares_every_slot(batches):
    picks = icp_loop.picks(batches, 8, 2 ** 31 + 5)
    assert [j for _, j in picks] == list(range(8))
    assert {i for i, _ in picks} <= set(batches)
    assert len({i for i, _ in picks}) == min(8, len(batches))
