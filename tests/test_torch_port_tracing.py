"""The port's spans (``deepi2p_tpu_torch/utils/profiling.py::span``) on the
CPU: nothing is recorded and no ``record_function`` is opened without a
profiler; under one, a train step's and an ICP batch's spans nest under
their top-level span and share its id, appear in the exported trace as
``user_annotation`` ranges (which ``is_span_range`` tells from
operations), and ``span_table`` counts them (device time None without a
card)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deepi2p_tpu_torch import config as tconfig
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.register import icp as ticp
from deepi2p_tpu_torch.register import pnp
from deepi2p_tpu_torch.train.engine import Engine
from deepi2p_tpu_torch.utils import profiling

from torch_port_fixtures import one_torch_thread, tmp_path  # noqa: F401

MAX_ITER = 30
TRAIN_SPANS = {"train.step", "train.forward", "train.loss", "train.backward",
               "train.adam", "detector.pc_encoder", "detector.img_encoder",
               "detector.fusion", "detector.head"}
ICP_SPANS = {"icp.batch", "icp.inits", "icp.nn1", "icp.update",
             "icp.fitness", "icp.pick"}
PNP_SPANS = {"pnp.draw", "pnp.dlt", "pnp.reproj", "pnp.polish", "pnp.gn"}
# the enclosing span of each span
PARENTS = {"train.forward": {"train.step"}, "train.loss": {"train.step"},
           "train.backward": {"train.step"}, "train.adam": {"train.step"},
           "detector.pc_encoder": {"train.forward"},
           "detector.img_encoder": {"train.forward"},
           "detector.fusion": {"train.forward"},
           "detector.head": {"train.forward"},
           "icp.inits": {"icp.batch"}, "icp.update": {"icp.batch"},
           "icp.fitness": {"icp.batch"}, "icp.pick": {"icp.batch"},
           "icp.nn1": {"icp.batch", "icp.fitness"},
           "pnp.gn": {"pnp.polish"}}
TOPS = {"train.step", "icp.batch", "pnp.draw", "pnp.dlt", "pnp.reproj",
        "pnp.polish"}


def train_step():
    cfg = tconfig.tiny(input_pt_num=64, node_a_num=8, node_b_num=8)
    engine = Engine(cfg, steps_per_epoch=10, device="cpu")
    state = engine.init_state(seed=0)
    state.step = 5
    engine.train_step(state, synthetic_batch(cfg, seed=1),
                      torch.Generator().manual_seed(2))


def icp_batch(batches=1):
    rng = np.random.default_rng(0)
    src = rng.uniform(-5, 5, (2, 64, 3)).astype(np.float32)
    tgt = src[:, :32] + 0.1
    for k in range(batches):
        ticp.icp_batch(src, tgt, torch.Generator().manual_seed(k), n_inits=8,
                       max_iter=MAX_ITER, device="cpu")


def pnp_batch():
    rng = np.random.default_rng(1)
    B, N = 1, 64
    pc = torch.from_numpy(np.concatenate(
        [rng.uniform(-3, 3, (B, N, 2)), rng.uniform(5, 20, (B, N, 1))],
        -1).astype(np.float32))
    K = torch.tensor([[[400.0, 0, 256], [0, 400.0, 80], [0, 0, 1]]])
    pnp.solve_pnp_batch(pc, torch.ones(B, N), torch.randint(
        0, 80, (B, N), generator=torch.Generator().manual_seed(3)), K,
        torch.Generator().manual_seed(4), W_fine=16, n_hypotheses=8)


RUNS = {"train": (train_step, TRAIN_SPANS), "icp": (icp_batch, ICP_SPANS),
        "pnp": (pnp_batch, PNP_SPANS)}


def profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()


@pytest.mark.parametrize("run", sorted(RUNS))
def test_no_profiler_no_record(run, monkeypatch):
    """Without a profiler a span opens no range, records no CUDA event and
    keeps no record."""
    def refuse(*a, **k):
        raise AssertionError("called without a profiler")
    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    RUNS[run][0]()
    assert profiling._LOG.records == [] and profiling.span_table() == {}
    assert "record_function" not in Path(pnp.__file__).read_text()


@pytest.mark.parametrize("run", ["train", "icp"])
def test_spans_nest_under_one_top_level_id(run):
    fn, names = RUNS[run]
    profiling.reset()
    profiled(fn)
    recs = profiling._LOG.records
    assert {r.name for r in recs} == names
    assert all(r.host_ns is not None and r.events is None for r in recs)
    for r in recs:
        if r.name in TOPS:
            assert r.parent is None
        else:
            assert r.parent.name in PARENTS[r.name], (r.name, r.parent.name)
    tops = {r.top for r in recs}
    assert len(tops) == 1
    if run == "train":
        assert tops == {("train.step", (("step", 5),))}
    profiling.reset()


def test_trace_holds_every_span_as_a_user_annotation(tmp_path):
    profiling.reset()
    with profiling.trace(str(tmp_path)) as prof:
        train_step()
        icp_batch()
        pnp_batch()
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert TRAIN_SPANS | ICP_SPANS | PNP_SPANS <= ranges
    # the rows a sum of device time over key_averages() leaves out
    rows = {e.key for e in prof.key_averages() if profiling.is_span_range(e)}
    assert rows == TRAIN_SPANS | ICP_SPANS | PNP_SPANS
    profiling.reset()


def test_span_table_counts_icp_iterations():
    profiling.reset()
    profiled(lambda: icp_batch(batches=2))
    table = profiling.span_table()
    assert table["icp.update"].calls == 2 * MAX_ITER
    assert table["icp.nn1"].calls == 2 * (MAX_ITER + 1)
    assert table["icp.batch"].calls == table["icp.update"].tops == 2
    for stats in table.values():
        assert stats.device_ms is None and stats.self_device_ms is None
        assert stats.host_ms > 0
    assert table["icp.batch"].host_ms > table["icp.update"].host_ms / 2
    profiling.reset()
    assert profiling.span_table() == {}


def test_span_table_self_time():
    """Self device time is a span's less its children's, summed by name
    over the calls; the distinct top-level ids count steps."""
    log = profiling.SpanLog()
    R = profiling.SpanRecord
    for step in (0, 1):
        top = ("train.step", (("step", step),))
        s = R("train.step", None, top, host_ns=4_000_000, device_ms=10.0)
        f = R("train.forward", s, top, host_ns=1_000_000, device_ms=4.0)
        h = R("detector.head", f, top, host_ns=500_000, device_ms=1.5)
        b = R("train.backward", s, top, host_ns=2_000_000, device_ms=5.0)
        log.records += [s, f, h, b]
    log.records.append(R("train.adam", None, ("train.adam", 9)))   # open
    t = log.table()
    assert set(t) == {"train.step", "train.forward", "detector.head",
                      "train.backward"}
    assert t["train.step"] == (2, 2, 8.0, 20.0, 2.0)
    assert t["train.forward"] == (2, 2, 2.0, 8.0, 5.0)
    assert t["detector.head"].self_device_ms == 3.0
