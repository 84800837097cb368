"""Where the training step's time goes on the card.

    python -m deepi2p_tpu_torch.profile_train

Runs the port's train step at the committed KITTI-shaped run
(``config.kitti`` street scenes, N=8192, 128+128 nodes, B=8, 160x512,
bf16 activations, seeded weights) and prints, for a profiled window of
steps after a warm-up: the program's span table
(``utils/profiling.py::span_table``: per span, calls, host ms and device
ms, whole and less the child spans, per step), the wall time per step,
the device's busy share, and the kernels with the most device time.
Needs a CUDA device.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType

from . import config
from .data import batch_to_torch, synthetic_batch
from .profile_slice import _device_us
from .train.engine import Engine
from .utils import profiling

WARMUP = 2
STEPS = 3        # timed and profiled steps
TOP = 25         # kernels listed


def main() -> None:
    cfg = config.kitti(synthetic_scene="street", input_pt_num=8192,
                       node_a_num=128, node_b_num=128)
    batch = batch_to_torch(synthetic_batch(cfg, seed=10), device="cuda")
    engine = Engine(cfg, device="cuda")
    state = engine.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(WARMUP):
        engine.train_step(state, batch, gen)
    torch.cuda.synchronize()
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            engine.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    print(f"card {torch.cuda.get_device_name(0)}; train step B="
          f"{cfg.batch_size} N={cfg.input_pt_num} {cfg.img_H}x{cfg.img_W} "
          f"{cfg.compute_dtype}")
    print(f"{'calls':>6} {'host ms':>9} {'device ms':>10} {'self ms':>9}  "
          "span (per step)")
    for name, s in profiling.span_table().items():
        dev = ("not measured" if s.device_ms is None else
               f"{s.device_ms / STEPS:10.3f} {s.self_device_ms / STEPS:9.3f}")
        print(f"{s.calls / STEPS:6.0f} {s.host_ms / STEPS:9.3f} {dev}  "
              f"{name}")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0
              and not profiling.is_span_range(e)]
    if not events:
        print("profiled: the trace holds no device time (not measured)")
        return
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    share = 100 * busy_ms / (wall * 1e3)
    print(f"profiled: wall {wall * 1e3 / STEPS:.3f} ms per step, device busy "
          f"{busy_ms / STEPS:.3f} ms per step ({share:.1f}% of the window), "
          f"{sum(e.count for e in events) // STEPS} kernel launches per step")
    events.sort(key=_device_us, reverse=True)
    print(f"{'device ms/step':>14} {'share':>6} {'calls':>6}  kernel")
    for e in events[:TOP]:
        ms = _device_us(e) / 1e3 / STEPS
        print(f"{ms:14.4f} {100 * ms * STEPS / busy_ms:5.1f}% "
              f"{e.count // STEPS:6d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
