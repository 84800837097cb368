"""The port's threaded ``BatchLoader`` and ``device_prefetch``: batch
order with the last partial batch dropped, a failing sample reaching the
consumer, one worker bitwise the JAX ``BatchLoader`` over a real loader,
four workers (and a stress run with more threads than cores) giving every
batch in order, an abandoned iterator releasing its threads, and the
prefetch to the CPU giving back the batch."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import deepi2p_tpu.data.native as jax_native
from deepi2p_tpu import config as jax_config
from deepi2p_tpu.data import BatchLoader as JaxBatchLoader
from deepi2p_tpu.data import KittiLoader as JaxKitti
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import (BatchLoader, KittiLoader,
                                    SyntheticDataset, device_prefetch)
from torch_port_data_trees import kitti_tree
from torch_port_fixtures import tmp_path  # noqa: F401

CFG = config.tiny(input_pt_num=64, node_a_num=8, node_b_num=8)


class Indexed:
    """Sample i is {"i": [i]}; optional failures and random delays."""

    def __init__(self, n, fail=(), delay=0.0):
        self.n, self.fail, self.delay = n, set(fail), delay
        self.calls = 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.calls += 1
        if self.delay:
            time.sleep(self.delay * ((i * 7919) % 5))
        if i in self.fail:
            raise IOError(f"corrupt sample {i}")
        return {"i": np.array([i])}


def indices(batches):
    return [b["i"][:, 0].tolist() for b in batches]


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("workers", [1, 4])
def test_order_and_drop_last(n, workers):
    bl = BatchLoader(Indexed(n), 4, shuffle=False, num_workers=workers)
    want = [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert len(bl) == len(want)
    assert indices(bl) == want
    order = np.arange(n)
    np.random.default_rng(3).shuffle(order)
    shuffled = BatchLoader(Indexed(n), 3, seed=3, num_workers=workers)
    assert indices(shuffled) == order[:n // 3 * 3].reshape(-1, 3).tolist()


@pytest.mark.parametrize("workers", [1, 2])
def test_failures_reach_the_consumer(workers):
    bad = BatchLoader(Indexed(8, fail={5}), 4, shuffle=False,
                      num_workers=workers)
    it = iter(bad)
    assert indices([next(it)]) == [[0, 1, 2, 3]]
    with pytest.raises(IOError, match="corrupt sample 5"):
        next(it)
    before = threading.active_count()
    with pytest.raises(IOError, match="corrupt sample 0"):
        list(BatchLoader(Indexed(16, fail={0}), 4, num_workers=workers,
                         shuffle=False))
    assert threading.active_count() <= before


def test_one_worker_matches_jax_batch_loader_on_kitti(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    root = kitti_tree(tmp_path / "kitti", np.random.default_rng(0))
    kw = dict(input_pt_num=128, node_a_num=8, node_b_num=8,
              accumulation_frame_num=1, accumulation_frame_skip=2,
              delta_ij_max=5)
    jax_ld = JaxKitti(root, "val", jax_config.tiny().replace(**kw), seed=0)
    port_ld = KittiLoader(root, "val", config.tiny().replace(**kw), seed=0,
                          native=False)
    jax_ld.mode = port_ld.mode = "train"
    want = list(JaxBatchLoader(jax_ld, 4, seed=2, num_workers=1))
    got = list(BatchLoader(port_ld, 4, seed=2, num_workers=1))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            if k == "img":
                assert np.abs(g[k] - w[k]).max() <= 1
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_four_workers_every_batch_in_order():
    ds = SyntheticDataset(CFG, length=12, seed=0)
    one = list(BatchLoader(ds, 3, seed=1, num_workers=1))
    four = list(BatchLoader(ds, 3, seed=1, num_workers=4, prefetch=1))
    assert len(four) == 4
    for a, b in zip(one, four):
        assert a["pc"].shape == (3, 64, 3) and a["img"].shape == (
            3, CFG.img_H, CFG.img_W, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_stress_more_threads_than_cores_and_abandoned_iterator():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ds = Indexed(96, delay=1e-4)
        bl = BatchLoader(ds, 4, seed=5, num_workers=16, prefetch=2)
        t = time.perf_counter()
        got = indices(bl)
        assert time.perf_counter() - t < 30
        order = np.arange(96)
        np.random.default_rng(5).shuffle(order)
        assert got == order.reshape(-1, 4).tolist()
        assert ds.calls == 96
        before = threading.active_count()
        it = iter(BatchLoader(Indexed(400, delay=1e-4), 4, num_workers=8))
        next(it)
        it.close()
        assert threading.active_count() <= before
    finally:
        sys.setswitchinterval(old)


def test_prefetch_to_cpu_gives_back_the_batch():
    ds = SyntheticDataset(CFG, length=6, seed=0)
    host = list(BatchLoader(ds, 2, shuffle=False))
    moved = list(device_prefetch(BatchLoader(ds, 2, shuffle=False), "cpu"))
    assert len(moved) == len(host) == 3
    for h, m in zip(host, moved):
        assert h.keys() == m.keys()
        for k in h:
            assert isinstance(m[k], torch.Tensor) and m[k].device.type == "cpu"
            np.testing.assert_array_equal(m[k].numpy(), h[k])
