"""The frustum solve's spans (``register/frustum.py``): under a profiler a
``solve_frustum_batch`` call records ``frustum.solve`` once as a top-level
span, and inside it each phase of its route once; without one it records
nothing."""
import pytest
import torch

from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.utils import profiling

from torch_port_fixtures import one_torch_thread  # noqa: F401

H, W = 32, 64
ROUTES = {
    # backend, inits, iterations -> the spans inside frustum.solve
    "kernel": ("kernel", 32, 10, {"frustum.inits", "frustum.probe",
                                  "frustum.select", "frustum.refine",
                                  "frustum.pick"}),
    "kernel_one_launch": ("kernel", 16, 10, {"frustum.inits", "frustum.lm",
                                             "frustum.pick"}),
    "fast": ("fast", 16, 10, {"frustum.inits", "frustum.probe",
                              "frustum.select", "frustum.refine",
                              "frustum.pick"}),
    "generic": ("generic", 8, 2, {"frustum.inits", "frustum.lm",
                                  "frustum.pick"}),
}


def solve(backend, n_inits, max_iter):
    g = torch.Generator().manual_seed(0)
    B, N = 2, 64
    pc = torch.cat([torch.rand(B, N, 2, generator=g) * 4 - 2,
                    torch.rand(B, N, 1, generator=g) * 10 + 5], -1)
    pred = (torch.rand(B, N, generator=g) < 0.5).float()
    f = 0.6 * W
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]).expand(
        B, 3, 3)
    return tf.solve_frustum_batch(pc, pred, K, H=H, W=W, generator=g,
                                  n_inits=n_inits, max_iter=max_iter,
                                  backend=backend)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_records_its_spans_once(route):
    backend, n_inits, max_iter, inner = ROUTES[route]
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        P, cost = solve(backend, n_inits, max_iter)
    recs = profiling._LOG.records
    assert sorted(r.name for r in recs) == sorted({"frustum.solve"} | inner)
    for r in recs:
        if r.name == "frustum.solve":
            assert r.parent is None
        else:
            assert r.parent.name == "frustum.solve", r.name
    table = profiling.span_table()
    assert table["frustum.solve"].calls == 1
    assert table["frustum.solve"].device_ms is None       # no card
    assert torch.isfinite(P).all() and torch.isfinite(cost).all()
    profiling.reset()


def test_no_profiler_no_record(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called without a profiler")
    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    solve("kernel", 32, 10)
    assert profiling._LOG.records == [] and profiling.span_table() == {}
