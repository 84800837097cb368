"""Time the 1-NN kernel at the ICP path's launches on the card.

    python -m deepi2p_tpu_torch.profile_nn1

The evaluation path's ICP (``register/icp.py``, KITTI B=8, N=20480, 64
inits) calls the 1-NN kernel once per iteration with every pair's 64 inits
applied to its source cloud, 512 query sets, against the 8 pseudo clouds
of 5120 rows (``config.kitti(synthetic_scene="street")``, the synthetic
batch of seed 0, ray-cast depth at stride 4).  This prints the kernel's
time by CUDA events over 5 calls after a warm-up at that launch and at
one init group (8 sets against one cloud).  It uses only the wrapper's
``nn1_cuda(q, db)``, so the same file times another checkout's kernel when
copied into its package.  Needs a CUDA device.
"""
from __future__ import annotations

import math

import torch

from . import config
from .data import synthetic_batch
from .ops.knn_cuda import nn1_cuda
from .register.icp import _draw_inits, _transform, depth_to_pointcloud

REPS = 5


def event_ms(fn, reps: int = REPS) -> float:
    """Mean time of ``fn()`` in ms by CUDA events over ``reps`` calls
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def icp_launch(raw, inits: int = 64):
    """(source (B, N, 3), clouds (B, M, 3), queries (B*inits, N, 3)) of
    one ICP iteration on a KITTI batch with dense depth (``raw``, numpy):
    the pseudo clouds at stride 4, every pair's inits applied to its
    source cloud."""
    source = torch.from_numpy(raw["pc"]).cuda()
    B, N, D = source.shape
    target = torch.stack([depth_to_pointcloud(
        torch.from_numpy(raw["depth"][b]).cuda(),
        torch.from_numpy(raw["K"][b]).cuda(), stride=4)
        for b in range(B)]).contiguous()
    P0 = _draw_inits(torch.Generator().manual_seed(5), (B, inits),
                     (5.0, 0.0, 10.0), math.pi).cuda()
    q = _transform(source[:, None], P0[..., :3, :3], P0[..., :3, 3])
    return source, target, q.reshape(B * inits, N, D).contiguous()


def main() -> None:
    print(f"card {torch.cuda.get_device_name(0)}", flush=True)
    cfg = config.kitti(synthetic_scene="street", batch_size=8)
    _, target, q = icp_launch(synthetic_batch(cfg, seed=0, with_depth=True,
                                              dense_depth=True))
    for name, qq, db in (("icp launch", q, target),
                         ("init group", q[:8].contiguous(),
                          target[:1].contiguous())):
        ms = event_ms(lambda: nn1_cuda(qq, db))
        print(f"nn1 {name}: S={qq.shape[0]} N={qq.shape[1]} "
              f"B={db.shape[0]} M={db.shape[1]}: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    with torch.no_grad():
        main()
