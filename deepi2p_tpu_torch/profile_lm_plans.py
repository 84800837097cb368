"""Time the LM kernel's launch plans on the card, in both modes.

    python -m deepi2p_tpu_torch.profile_lm_plans [--chosen]

The kernel (``csrc/frustum_lm.cu``) runs one cluster of C blocks per
(pair, group of G inits), W warps per init; ``lm_plan`` picks (C, G, W)
from the shapes and the mode (P = 4: 2-D, P = 6: 6-DoF).  This runs the
halving solve's two launches at the Oxford main path (B=32, solver stride
2: probe N=5120 I=64 8 iterations, refine N=10240 I=8 16 iterations, the
seeded model's labels) and at the KITTI evaluation path (B=8, every
point: probe N=5120 I=64 8 iterations, refine N=20480 I=8 24 iterations,
the true pose's labels) at each plan of :data:`PLANS` and at the chosen
one, and prints for each the time (CUDA events over 5 launches after a
warm-up) and how many costs equal the plain version's, which sums in that
plan's order.  With ``--chosen`` it times only the launch the solve
makes (no plan is named and no plain version run), which uses only
``lm_solve_cuda`` and so times another checkout's kernel when this file
is copied into its package.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import torch

from . import config
from .data import batch_to_torch, synthetic_batch
from .models import build_detector
from .register import initial_guess, sample_inits
from .register.frustum_cuda import lm_solve_cuda

# (C blocks per cluster, G inits per block, W warps per init), by mode
PLANS = {
    4: [(1, 8, 1), (1, 8, 2), (1, 4, 4), (2, 8, 1), (2, 4, 2), (2, 4, 4),
        (2, 8, 2), (2, 1, 16), (4, 8, 1), (4, 4, 2), (4, 4, 1), (4, 1, 16),
        (8, 8, 1), (8, 4, 1), (8, 4, 2), (8, 1, 16)],
    6: [(1, 8, 1), (1, 4, 2), (2, 8, 1), (2, 4, 2), (2, 2, 4), (2, 1, 8),
        (4, 8, 1), (4, 2, 4), (4, 1, 8), (8, 8, 1), (8, 1, 8)],
}
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


def _plan_cells(P, args, iters, kw):
    """(chosen plan, cells) of every plan of the mode at one launch."""
    from .register.frustum_cuda import lm_plan, lm_solve_plain

    B, N, _ = args[0].shape
    chosen = lm_plan(B, N, args[4].shape[1], P)
    cells = []
    for plan in PLANS[P] + ([chosen] if chosen not in PLANS[P] else []):
        _, c_k = lm_solve_cuda(*args, max_iter=iters, _plan=plan, **kw)
        _, c_p = lm_solve_plain(*args, max_iter=iters, _plan=plan, **kw)
        same = int((c_k == c_p).sum())
        ms = _ms(lambda: lm_solve_cuda(*args, max_iter=iters, _plan=plan,
                                       **kw))
        cells.append(f"{plan} {ms:.4f} ({same}/{c_p.numel()})")
    return chosen, cells


def sweep(tag, P, pc, labels, K, H: int, W: int, stride: int,
          max_iter: int, chosen_only: bool) -> None:
    """Both launches of the halving solve in mode P on these inputs."""
    kw = dict(H=H, W=W)
    ang, valid = initial_guess(pc, labels)
    theta = sample_inits(torch.Generator().manual_seed(1), ang, 64,
                         is_2d=P == 4)
    full = [x[:, ::stride].contiguous() for x in (pc, labels.float(), valid)]
    probe = [x[:, ::max(1, 4 // stride)].contiguous() for x in full]
    for name, inputs, iters in (("probe", probe, 8),
                                ("refine", full, max_iter - 8)):
        args = (*inputs, K, theta.contiguous(), T_LB, T_UB)
        B, N, _ = inputs[0].shape
        head = (f"{tag} P={P} {name}: B={B} N={N} I={theta.shape[1]} "
                f"iters={iters}")
        if chosen_only:
            ms = _ms(lambda: lm_solve_cuda(*args, max_iter=iters, **kw))
            print(f"{head}; the solve's launch {ms:.4f} ms", flush=True)
        else:
            chosen, cells = _plan_cells(P, args, iters, kw)
            print(f"{head}; chosen {chosen}; ms by plan (C, G, W), costs "
                  f"bitwise equal to the plain version's: "
                  + ", ".join(cells), flush=True)
        if name == "probe":
            th, c = lm_solve_cuda(*args, max_iter=iters, **kw)
            top = torch.argsort(c, dim=1, stable=True)[:, :8]
            theta = torch.gather(th, 1, top[:, :, None].expand(-1, -1, P))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chosen", action="store_true",
                    help="time only the launch the solve makes")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card {torch.cuda.get_device_name(0)}", flush=True)
    with torch.no_grad():
        cfg = config.oxford(batch_size=32)
        b = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")
        model = build_detector(cfg, device="cuda", seed=0)
        pred = torch.argmax(model(*(b[k] for k in KEYS))[0], dim=-1)
        del model
        for P in (4, 6):
            sweep("oxford", P, b["pc"], pred, b["K"].contiguous(),
                  cfg.img_H, cfg.img_W, stride=2, max_iter=24,
                  chosen_only=a.chosen)
        cfg = config.kitti(synthetic_scene="street", batch_size=8)
        b = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")
        for P in (4, 6):
            sweep("kitti", P, b["pc"], _true_labels(b, cfg.img_H, cfg.img_W),
                  b["K"].contiguous(), cfg.img_H, cfg.img_W, stride=1,
                  max_iter=32, chosen_only=a.chosen)


if __name__ == "__main__":
    main()
