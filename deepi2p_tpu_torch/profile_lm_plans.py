"""Time the 2-D LM kernel's launch plans on the card.

    python -m deepi2p_tpu_torch.profile_lm_plans

The P = 4 kernel (``csrc/frustum_lm.cu``) runs one cluster of C blocks per
(pair, group of G inits), W warps per init; ``lm_p4_plan`` picks (C, G, W)
from the shapes.  This runs the halving solve's two launches at the
Oxford main path (B=32, solver stride 2: probe N=5120 I=64 8 iterations,
refine N=10240 I=8 16 iterations, the seeded model's labels) and at the
KITTI evaluation path (B=8, every point: probe N=5120 I=64 8 iterations,
refine N=20480 I=8 24 iterations, the true pose's labels) at each plan of
:data:`PLANS` and at the chosen one, and prints for each the time (CUDA
events over 5 launches after a warm-up) and how many costs equal the
plain version's, which sums in that plan's order.  Needs a CUDA device.
"""
from __future__ import annotations

import torch

from . import config
from .data import batch_to_torch, synthetic_batch
from .models import build_detector
from .register import initial_guess, sample_inits
from .register.frustum_cuda import lm_p4_plan, lm_solve_cuda, lm_solve_plain

# (C blocks per cluster, G inits per block, W warps per init)
PLANS = [(1, 8, 1), (1, 8, 2), (1, 4, 4), (2, 8, 1), (2, 4, 2), (2, 4, 4),
         (2, 8, 2), (2, 1, 16), (4, 8, 1), (4, 4, 2), (4, 4, 1), (4, 1, 16),
         (8, 8, 1), (8, 4, 1), (8, 4, 2), (8, 1, 16)]
T_LB, T_UB = (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0)
KEYS = ("pc", "intensity", "sn", "node_a", "node_b", "img")


def _ms(fn, reps: int = 5) -> float:
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


def _true_labels(b, H: int, W: int) -> torch.Tensor:
    """Inside-frustum labels of the true pose, (B, N) int64."""
    cam = b["pc"] @ b["P"][:, :3, :3].transpose(1, 2) + b["P"][:, None, :3, 3]
    hom = cam @ b["K"].transpose(1, 2)
    z = hom[..., 2]
    px, py = hom[..., 0] / z, hom[..., 1] / z
    return ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
            & (z > 0.1)).long()


def sweep(tag, pc, labels, K, H: int, W: int, stride: int,
          max_iter: int) -> None:
    """Both launches of the halving solve on these inputs, every plan."""
    kw = dict(H=H, W=W)
    ang, valid = initial_guess(pc, labels)
    theta = sample_inits(torch.Generator().manual_seed(1), ang, 64)
    full = [x[:, ::stride].contiguous() for x in (pc, labels.float(), valid)]
    probe = [x[:, ::max(1, 4 // stride)].contiguous() for x in full]
    for name, inputs, iters in (("probe", probe, 8),
                                ("refine", full, max_iter - 8)):
        args = (*inputs, K, theta.contiguous(), T_LB, T_UB)
        B, N, _ = inputs[0].shape
        chosen = lm_p4_plan(B, N, theta.shape[1])
        cells = []
        for plan in PLANS + ([chosen] if chosen not in PLANS else []):
            _, c_k = lm_solve_cuda(*args, max_iter=iters, _plan=plan, **kw)
            th_p, c_p = lm_solve_plain(*args, max_iter=iters, _plan=plan,
                                       **kw)
            same = int((c_k == c_p).sum())
            ms = _ms(lambda: lm_solve_cuda(*args, max_iter=iters,
                                           _plan=plan, **kw))
            cells.append(f"{plan} {ms:.4f} ({same}/{c_p.numel()})")
        print(f"{tag} {name}: B={B} N={N} I={theta.shape[1]} iters={iters}; "
              f"chosen {chosen}; ms by plan (C, G, W), costs bitwise equal "
              f"to the plain version's: " + ", ".join(cells), flush=True)
        if name == "probe":
            top = torch.argsort(c_p, dim=1, stable=True)[:, :8]
            theta = torch.gather(th_p, 1, top[:, :, None].expand(-1, -1, 4))


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card {torch.cuda.get_device_name(0)}", flush=True)
    with torch.no_grad():
        cfg = config.oxford(batch_size=32)
        b = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")
        model = build_detector(cfg, device="cuda", seed=0)
        pred = torch.argmax(model(*(b[k] for k in KEYS))[0], dim=-1)
        del model
        sweep("oxford", b["pc"], pred, b["K"].contiguous(), cfg.img_H,
              cfg.img_W, stride=2, max_iter=24)
        cfg = config.kitti(synthetic_scene="street", batch_size=8)
        b = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")
        sweep("kitti", b["pc"], _true_labels(b, cfg.img_H, cfg.img_W),
              b["K"].contiguous(), cfg.img_H, cfg.img_W, stride=1,
              max_iter=32)


if __name__ == "__main__":
    main()
