"""The JAX package's solver quality gates on the port's solve
(``tests/test_frustum.py:182`` and ``:294``), with the port's
``register/noise.py`` (bitwise the JAX package's,
``tests/test_torch_port_noise.py``) and the committed ``tests/fixtures/
error_structure.json``, at the same gates; and the successive-halving
knobs: the defaults leave the launch plan unchanged, and the harness
forwards ``probe_stride`` / ``survivors`` to the same solve as a direct
call."""
import json
import os

import numpy as np
import pytest
import torch

from deepi2p_tpu_torch.eval.dump import save_sample_dump
from deepi2p_tpu_torch.eval.harness import evaluate_registration
from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.register import noise
from deepi2p_tpu_torch.register.metrics import pose_diff_np

from test_frustum import H, K_np, W, _make_problem

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "error_structure.json")


def _gate_solve(pcs, labs, Ps):
    """The bench config of the JAX gates: 64 inits, 24 iterations, solver
    stride 2; the port's inits from a CPU generator of seed 0."""
    B = len(pcs)
    P_pred, _ = tf.solve_frustum_batch(
        torch.as_tensor(np.stack(pcs)),
        torch.as_tensor(np.stack(labs).astype(np.float32)),
        torch.as_tensor(np.tile(K_np, (B, 1, 1))), H=H, W=W,
        generator=torch.Generator().manual_seed(0), n_inits=64, max_iter=24,
        solver_stride=2)
    oks = [pose_diff_np(P_pred[b].double().numpy(), Ps[b].astype(np.float64))
           for b in range(B)]
    return sum(rte < 2.0 and rre < 5.0 for rte, rre in oks)


def test_bench_config_quality_gate(rng):
    """``test_bench_config_quality_gate``: 10% i.i.d. flips, >= 5 of 6."""
    pcs, labs, Ps = [], [], []
    for _ in range(6):
        yaw = rng.uniform(-np.pi, np.pi)
        t = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)],
                     np.float32)
        pc, labels, P = _make_problem(rng, yaw, t, n=4096)
        flip = rng.uniform(size=len(labels)) < 0.10
        labels = np.where(flip, 1 - labels, labels)
        pcs.append(pc); labs.append(labels); Ps.append(P)
    ok = _gate_solve(pcs, labs, Ps)
    assert ok >= 5, f"success {ok}/6 below gate at bench config"


def test_bench_config_quality_gate_real_structure(rng):
    """``test_bench_config_quality_gate_real_structure``: the measured
    border-band and off-band error rates of a real dump, through the
    port's noise models, at the fixture's gate (default 4 of 6)."""
    assert os.path.isfile(FIXTURE), "tests/fixtures/error_structure.json"
    with open(FIXTURE) as f:
        fix = json.load(f)
    pcs, labs, Ps = [], [], []
    for _ in range(6):
        yaw = rng.uniform(-np.pi, np.pi)
        t = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)],
                     np.float32)
        pc, labels, P = _make_problem(rng, yaw, t, n=4096)
        labels = noise.flip_border_band(rng, labels, pc, P, K_np, H, W,
                                        band_px=fix["band_px"],
                                        rate=fix["band_error_rate"])
        labels = noise.flip_iid(rng, labels, fix["offband_error_rate"])
        pcs.append(pc); labs.append(labels); Ps.append(P)
    ok = _gate_solve(pcs, labs, Ps)
    assert ok >= fix.get("gate_min_success", 4), \
        f"success {ok}/6 below gate at measured error structure"


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(3):
        pc, labels, P = _make_problem(
            rng, rng.uniform(-np.pi, np.pi),
            np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)],
                     np.float32), n=2048)
        out.append((pc, labels, P))
    return out


def _record(monkeypatch):
    """Record each LM launch as (points, inits, iterations)."""
    plan, lm = [], tf.lm_solve

    def recording(pts, labels, valid, K, theta0, *a, max_iter, **kw):
        plan.append((pts.shape[1], theta0.shape[1], max_iter))
        return lm(pts, labels, valid, K, theta0, *a, max_iter=max_iter, **kw)
    monkeypatch.setattr(tf, "lm_solve", recording)
    return plan


def test_knob_defaults_keep_the_plan(pairs, monkeypatch):
    """Unset knobs, and knobs set to their defaults, launch the same plan
    (probe every 4th point, every 2nd of the stride-2 subsample, with all
    64 inits for 8 iterations; refine the best 8 at stride 2 for 16) with the same poses; other values change only the
    probe stride and the refine width."""
    plan = _record(monkeypatch)
    args = [torch.as_tensor(np.stack([p[i] for p in pairs]))
            for i in range(2)]
    K = torch.as_tensor(np.tile(K_np, (3, 1, 1)))
    kw = dict(H=H, W=W, n_inits=64, max_iter=24, solver_stride=2)

    def solve(**knobs):
        plan.clear()
        P, cost = tf.solve_frustum_batch(
            *args, K, generator=torch.Generator().manual_seed(0), **kw,
            **knobs)
        return list(plan), P, cost

    plan0, P0, c0 = solve()
    assert plan0 == [(512, 64, 8), (1024, 8, 16)]
    plan1, P1, c1 = solve(probe_stride=2, survivors=8)
    assert plan1 == plan0
    torch.testing.assert_close(P1, P0, rtol=0, atol=0)
    torch.testing.assert_close(c1, c0, rtol=0, atol=0)
    plan2, _, _ = solve(probe_stride=4, survivors=20)
    assert plan2 == [(256, 64, 8), (1024, 16, 16)]
    plan3, _, _ = solve(survivors=3)           # at least one block of 8
    assert plan3 == plan0


def test_harness_forwards_knobs(pairs, tmp_path, monkeypatch):
    """``probe_stride`` / ``survivors`` through the harness give the direct
    call's poses; without them the harness launches the default plan."""
    for i, (pc, labels, P) in enumerate(pairs):
        save_sample_dump(str(tmp_path), f"{i:06d}_00", pc=pc,
                         coarse_pred=labels, coarse_label=labels,
                         fine_pred=labels, fine_label=labels, K=K_np,
                         P=P[:3])
    plan = _record(monkeypatch)
    save = tmp_path / "save"
    kw = dict(method="frustum", H=H, W=W, n_inits=64, max_iter=24,
              device="cpu", batch_size=3)
    evaluate_registration(str(tmp_path), probe_stride=8, survivors=16,
                          save_dir=str(save), **kw)
    assert plan == [(256, 64, 8), (2048, 16, 16)]
    P_direct, _ = tf.solve_frustum_batch(
        *(torch.as_tensor(np.stack([p[i] for p in pairs])) for i in range(2)),
        torch.as_tensor(np.tile(K_np, (3, 1, 1))), H=H, W=W,
        generator=torch.Generator().manual_seed(0), n_inits=64, max_iter=24,
        probe_stride=8, survivors=16)
    np.testing.assert_array_equal(np.load(save / "P_pred_all_np.npy"),
                                  P_direct.double().numpy())
    plan.clear()
    evaluate_registration(str(tmp_path), **kw)
    assert plan == [(512, 64, 8), (2048, 8, 16)]
