"""Where the main path's time goes on the card.

    python -m deepi2p_tpu_torch.profile_slice

Runs the port's main path (``config.oxford(batch_size=32)``, seeded
weights in bf16, forward -> argmax -> ``solve_frustum_batch`` with the JAX
bench's settings) under ``torch.profiler`` after a warm-up, and prints:
the wall time per step; the device time of the forward and of the solve
(CUDA events); the device's busy share of the profiled window; and the
kernels with the most device time.  Needs a CUDA device.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType

from . import config
from .data import batch_to_torch, synthetic_batch
from .models import build_detector
from .register import solve_frustum_batch
from .utils import profiling

KEYS = ("pc", "intensity", "sn", "node_a", "node_b", "img")
STEPS = 2        # profiled steps, after one warm-up step
TOP = 25         # kernels listed


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> None:
    cfg = config.oxford(batch_size=32)
    batch = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")
    model = build_detector(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def forward():
        coarse, _ = model(*(batch[k] for k in KEYS))
        return torch.argmax(coarse, dim=-1)

    def solve(pred):
        return solve_frustum_batch(batch["pc"], pred, batch["K"], H=cfg.img_H,
                                   W=cfg.img_W, generator=gen, n_inits=64,
                                   max_iter=24, solver_stride=2)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    with torch.no_grad():
        solve(forward())                                  # warm-up
        torch.cuda.synchronize()
        fwd_ms, solve_ms = [], []
        for _ in range(STEPS):
            pred, ms = timed(forward)
            fwd_ms.append(ms)
            _, ms = timed(lambda: solve(pred))
            solve_ms.append(ms)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                solve(forward())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    print(f"card {torch.cuda.get_device_name(0)}; {STEPS} steps of "
          f"B={cfg.batch_size}")
    print(f"forward {sum(fwd_ms) / len(fwd_ms):.3f} ms, solve "
          f"{sum(solve_ms) / len(solve_ms):.3f} ms per step (CUDA events)")
    # kernel rows only (the CPU ops' rows repeat their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0
              and not profiling.is_span_range(e)]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not events:
        print("profiled: the trace holds no device time (not measured)")
        return
    print(f"profiled: wall {wall * 1e3 / STEPS:.3f} ms per step, "
          f"device busy {busy_ms / STEPS:.3f} ms per step "
          f"({100 * busy_ms / (wall * 1e3):.1f}% of the window)")
    events.sort(key=_device_us, reverse=True)
    print(f"{'device ms/step':>14} {'share':>6} {'calls':>6}  kernel")
    for e in events[:TOP]:
        ms = _device_us(e) / 1e3 / STEPS
        print(f"{ms:14.4f} {100 * ms * STEPS / busy_ms:5.1f}% "
              f"{e.count // STEPS:6d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
