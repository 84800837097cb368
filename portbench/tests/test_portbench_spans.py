"""The per-layer metrics that read the program's spans: their arithmetic on
a made-up span table, nothing where the table has no device time, no
top-level span or no table at all, and a tiny traced run on the CPU that
reports none of them and raises nothing."""
import pytest

from deepi2p_tpu_torch.utils import profiling
from portbench import run
from portbench.tests.tiny import run_tiny

S = profiling.SpanStats
TABLE = {
    "train.step": S(calls=4, tops=4, host_ms=300.0, device_ms=760.0,
                    self_device_ms=4.0),
    "train.forward": S(4, 4, 80.0, 280.0, 100.0),
    "train.loss": S(4, 4, 20.0, 40.0, 40.0),
    "train.backward": S(4, 4, 150.0, 400.0, 400.0),
    "train.adam": S(4, 4, 40.0, 36.0, 36.0),
    "icp.batch": S(2, 2, 1300.0, 1280.0, 20.0),
    "icp.update": S(60, 2, 500.0, 180.0, 180.0),
}
# metric -> its value on TABLE, and the top-level span it is read per
EXPECTED = {"train_forward_ms": (70.0, "train.step"),
            "train_backward_ms": (100.0, "train.step"),
            "train_adam_ms": (9.0, "train.step"),
            "train_host_ms": (75.0, "train.step"),
            "icp_update_ms": (90.0, "icp.batch")}


def reader(name):
    return run.load_module(run.metric_file(run.HERE, name))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reading_of_a_span_table(name, monkeypatch):
    value, top = EXPECTED[name]
    read = reader(name).read
    monkeypatch.setattr(profiling, "span_table", lambda: dict(TABLE))
    assert read(None) == pytest.approx(value)
    no_card = {k: v._replace(device_ms=None, self_device_ms=None)
               for k, v in TABLE.items()}
    monkeypatch.setattr(profiling, "span_table", lambda: no_card)
    assert read(None) is None
    monkeypatch.setattr(profiling, "span_table",
                        lambda: {k: v for k, v in TABLE.items() if k != top})
    assert read(None) is None
    monkeypatch.delattr(profiling, "span_table")      # a program without it
    assert read(None) is None


@pytest.mark.parametrize("cell", ["kitti.train", "kitti.icp"])
def test_traced_tiny_run_reads_no_span_metric_on_the_cpu(cell):
    profiling.reset()
    result, _ = run_tiny(cell, trace=True)
    assert result["correct"] and "breakdown" in result
    assert not set(EXPECTED) & set(result["metrics"])
    # the spans record only in the profiled window: one batch at tiny size
    top = "train.step" if cell == "kitti.train" else "icp.batch"
    table = profiling.span_table()
    assert table[top].calls == 1 and table[top].device_ms is None
    profiling.reset()
