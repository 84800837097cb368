#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  It imports
``deepi2p_tpu_torch`` only, never JAX or the JAX package.  Phases, each
announced as ``phase=<name> start|done t=<seconds>``:

1. ``device``: the card's name and power limit (``nvidia-smi``); fails
   without a CUDA device.  TF32 is switched off for matmuls and cuDNN, so
   every f32 comparison below is a true f32 one.
2. ``build``: one ``nvcc -c`` per ``deepi2p_tpu_torch/csrc/*.cu``, all
   started together, then one link.
3. ``data``: the Oxford-shaped synthetic batch (B=32, N=20480, 384x640).
4. ``model``: ``config.oxford(batch_size=32)`` with seeded weights, bf16
   as the config says; one forward gives the labels the solve sees.
5. ``knn``: the kNN kernel against its plain version at the four shapes of
   the forward: indices equal, distances within 1e-5 relative; times of
   the kernel, the plain version and ``torch.cdist`` + ``torch.topk``.
6. ``lm``: the LM kernel against its plain version at the solve's probe
   and refine shapes, on the model's labels and on those of the true
   pose: the same NaN pattern, costs within 1e-4 relative, theta within
   1e-3 absolute (both sum in the same order, so what may remain is the
   rounding of the CUDA and PyTorch math functions).
7. ``slice``: forward -> argmax -> ``solve_frustum_batch`` (64 inits, 24
   iterations, solver stride 2), three times after one warm-up, with the
   launch counts set to 0 just before; each kernel must have launched
   (4 kNN per forward, 2 LM per solve) and every output must be finite.
8. ``nn1``: the 1-NN kernel against its plain version at the ICP
   path's launch shape (8 KITTI clouds, N=20480, each moved by its 64
   inits: 512 query sets against the 8 pseudo clouds of M=5120, 64 sets
   per cloud), and at one init group (8 sets) against one cloud cut to
   M=5000 and padded back with 1e6 sentinel rows, as the harness pads,
   and cut to M=5000 unpadded: indices equal, distances max abs err
   reported (0 expected).  Times of the kernel and the plain version at
   the launch shape, of the kernel and ``torch.cdist`` + ``torch.min`` at
   one init group; then one ICP batch timed and under ``torch.profiler``
   (1-NN vs SVD vs gathers).
9. ``lm6``: the LM kernel's 6-DoF mode against its plain version at the
   6-DoF solve's probe (N=5120, 64 inits, 8 iterations) and refine
   (N=10240, 8 inits, 16 iterations) shapes, on the model's labels, on
   those of the true pose, and from zero-angle inits (the first-order
   rotation branch); the ``lm`` tolerances.  The points behind any
   non-finite cost are printed.
10. ``solve6``: forward -> argmax -> ``solve_frustum_batch(is_2d=False)``
    at the main path's settings, three steps after a warm-up: 2 launches
    of the 6-DoF LM per solve, finite poses, pairs/s, and the success
    rate of a solve from the true pose's labels.
11. ``eval``: the evaluation path end to end at the KITTI shape (B=8,
    N=20480, 160x512, street scenes): the seeded detector's
    ``dump_predictions`` into a temporary directory, pseudo clouds from
    the ray-cast depth (stride 4, M=5120), then ``evaluate_registration``
    with ``icp`` (60 inits, 30 iterations), ``frustum`` (on the labels and
    on the predictions) and ``random``: finite summaries, at least 31
    1-NN launches per ICP batch, and kNN and 2-D LM launches.
12. ``reference``: a small input (``config.tiny()``, f32) through the card
    path and the CPU path (the plain versions, which the CPU tests hold to
    the JAX package): logits and solved poses (2-D and 6-DoF) must agree.

Then a ``kernels=`` line, one JSON line of per-kernel numbers (launches
from the path each kernel serves: ``slice`` for kNN and the 2-D LM,
``solve6`` for the 6-DoF LM, ``eval`` for the 1-NN), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  A watchdog ends a hung run after
420 s with a traceback and a nonzero exit; any failed check exits nonzero
before the last line is printed.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 420
T0 = time.perf_counter()

# main-path settings (the JAX package's bench.py)
BATCH = 32
N_INITS = 64
MAX_ITER = 24
SOLVER_STRIDE = 2
PROBE_ITER = 8

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# the evaluation path (KITTI shape, the JAX icp_batch defaults)
EVAL_BATCH = 8
ICP_INITS = 60        # rounded up to 64 by init_chunk=8
ICP_ITERS = 30
PSEUDO_STRIDE = 4     # 160x512 depth -> M = 5120 pseudo points
NN1_SETS = 8          # one ICP init group

KNN_RTOL = 1e-5
LM_COST_RTOL = 1e-4
LM_THETA_ATOL = 1e-3
REF_LOGIT_RTOL = 1e-4
REF_POSE_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


@contextlib.contextmanager
def phase(name: str):
    log(f"phase={name} start t={time.perf_counter() - T0:.1f}")
    yield
    log(f"phase={name} done t={time.perf_counter() - T0:.1f}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events, after a warm-up
    call."""
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def frustum_labels(torch, pc, P, K, H: int, W: int):
    """Inside-frustum labels of the true pose (B, N) int64."""
    cam = pc @ P[:, :3, :3].transpose(1, 2) + P[:, None, :3, 3]
    hom = cam @ K.transpose(1, 2)
    z = hom[..., 2]
    px, py = hom[..., 0] / z, hom[..., 1] / z
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & (z > 0.1)
    return inside.long()


def knn_phase(torch, batch, cfg):
    from deepi2p_tpu_torch.ops import knn_plain, node_mean_and_count
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda

    bf = lambda t: t.to(torch.bfloat16).float().contiguous()
    pc, na, nb = batch["pc"], batch["node_a"], batch["node_b"]
    _, idx1 = knn_cuda(bf(pc), bf(na), cfg.k_interp_point_a)
    cmean, _ = node_mean_and_count(bf(pc), idx1[:, :, 0], cfg.node_a_num)
    # the forward's four calls: encoder point->node_a and node_b->cluster
    # means (bf16-rounded coordinates), point->node_b and node_a->node_b
    calls = [("pc->node_a", bf(pc), bf(na), cfg.k_interp_point_a),
             ("node_b->cluster_mean", bf(nb), cmean.contiguous(), cfg.k_ab),
             ("pc->node_b", pc, nb, cfg.k_interp_point_b),
             ("node_a->node_b", na, nb, cfg.k_interp_ab)]
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0, bound_by=None)
    for name, q, db, k in calls:
        d2_k, idx_k = knn_cuda(q, db, k)
        d2_p, idx_p = knn_plain(q, db, k)
        torch.cuda.synchronize()
        require(bool(torch.equal(idx_k, idx_p)),
                f"knn {name}: indices differ from the plain version at "
                f"{int((idx_k != idx_p).sum())} places")
        err = float((d2_k - d2_p).abs().max())
        rel = err / max(float(d2_p.abs().max()), 1e-30)
        require(rel <= KNN_RTOL, f"knn {name}: d2 rel err {rel:.3g}")
        require(int(idx_k.min()) >= 0 and int(idx_k.max()) < db.shape[1],
                f"knn {name}: index out of range")
        ms = cuda_ms(torch, lambda: knn_cuda(q, db, k), 20)
        plain_ms = cuda_ms(torch, lambda: knn_plain(q, db, k), 3)
        lib_ms = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(q, db), k, dim=-1, largest=False), 5)
        B, N, D = q.shape
        M = db.shape[1]
        nbytes = 4 * (B * N * D + B * M * D) + 8 * B * N * k
        ops = B * N * M * (3 * D - 1 + 1)   # distance, then one compare
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"knn {name}: B={B} N={N} M={M} D={D} k={k} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f} max_abs_err={err:.3g}")
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += lib_ms
        row["bound_ms"] += bound
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return row


def compare_lm(torch, tag, args, kw):
    """Kernel vs plain LM on the same inputs; NaN where one has NaN."""
    from deepi2p_tpu_torch.register import lm_solve_cuda, lm_solve_plain

    th_k, c_k = lm_solve_cuda(*args, **kw)
    th_p, c_p = lm_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    require(bool(torch.equal(torch.isnan(c_k), torch.isnan(c_p))
                 and torch.equal(torch.isnan(th_k), torch.isnan(th_p))),
            f"lm {tag}: NaN pattern differs from the plain version")
    fin = torch.isfinite(c_p)
    crel = float(((c_k - c_p).abs() / c_p.abs().clamp(min=1e-6))[fin]
                 .max()) if bool(fin.any()) else 0.0
    tfin = torch.isfinite(th_p)
    terr = float((th_k - th_p).abs()[tfin].max()) if bool(tfin.any()) else 0.0
    log(f"lm {tag}: cost max rel err {crel:.3g}, theta max abs err "
        f"{terr:.3g}; bitwise equal costs {int((c_k == c_p).sum())} of "
        f"{c_k.numel()}, non-finite costs {int((~fin).sum())}, non-finite "
        f"theta entries {int((~tfin).sum())}")
    require(crel <= LM_COST_RTOL, f"lm {tag}: cost rel err {crel:.3g}")
    require(terr <= LM_THETA_ATOL, f"lm {tag}: theta abs err {terr:.3g}")
    return th_p, c_p, terr


def lm_bound(inputs, I: int, iters: int, P: int):
    """(bound ms, bound_by) of one LM launch from its shapes: the ops
    counted from the kernel per point, init and sweep, against each input
    read once (points, labels, valid, K, theta0) and each output written
    once (theta, cost)."""
    from deepi2p_tpu_torch.register.frustum_cuda import (LM6_OPS_PER_POINT,
                                                         LM_OPS_PER_POINT)
    B, N, _ = inputs[0].shape
    per_point = LM_OPS_PER_POINT if P == 4 else LM6_OPS_PER_POINT
    ops = per_point * B * I * N * (iters + 1)
    nbytes = 4 * (5 * B * N + 9 * B + 2 * P * B * I + B * I)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def lm_phase(torch, batch, cfg, pred):
    """The LM kernel at the solve's probe and refine shapes, on the main
    path's own inputs (the seeded model's labels) and on the labels of
    the true pose."""
    from deepi2p_tpu_torch.register import (initial_guess, lm_solve_cuda,
                                            lm_solve_plain, sample_inits)

    H, W = cfg.img_H, cfg.img_W
    kw = dict(H=H, W=W)
    t_lb, t_ub = (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0)
    pc, K = batch["pc"], batch["K"].contiguous()
    truth = frustum_labels(torch, pc, batch["P"], batch["K"], H, W)
    s, ps = SOLVER_STRIDE, max(1, 4 // SOLVER_STRIDE)
    keep = max((N_INITS // 8) // 8 * 8, 8)

    def sub(x, stride):
        return x[:, ::stride].contiguous()

    row = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               max_abs_err=0.0, bound_by=None)
    for lab_name, labels in (("truth", truth), ("model", pred)):
        ang, valid = initial_guess(pc, labels)
        gen = torch.Generator(device=pc.device).manual_seed(1)
        theta = sample_inits(gen, ang, N_INITS).contiguous()
        full = [sub(x, s) for x in (pc, labels.float(), valid)]
        probe = [sub(x, ps) for x in full]
        for name, inputs, iters in (("probe", probe, PROBE_ITER),
                                    ("refine", full, MAX_ITER - PROBE_ITER)):
            args = (*inputs, K, theta, t_lb, t_ub)
            th_p, c_p, terr = compare_lm(
                torch, f"{name} ({lab_name} labels)", args,
                dict(kw, max_iter=iters))
            row["max_abs_err"] = max(row["max_abs_err"], terr)
            if lab_name == "model":
                ms = cuda_ms(torch, lambda: lm_solve_cuda(
                    *args, max_iter=iters, **kw), 5)
                plain_ms = cuda_ms(torch, lambda: lm_solve_plain(
                    *args, max_iter=iters, **kw), 1)
                B, N, _ = inputs[0].shape
                I = theta.shape[1]
                bound, row["bound_by"] = lm_bound(inputs, I, iters, 4)
                log(f"lm {name}: B={B} N={N} I={I} iters={iters} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound:.5f}")
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["bound_ms"] += bound
            if name == "probe":
                top = torch.argsort(c_p, dim=1, stable=True)[:, :keep]
                theta = torch.gather(
                    th_p, 1, top[:, :, None].expand(-1, -1, 4)).contiguous()
    return row


def slice_phase(torch, model, batch, cfg):
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import lm_solve_cuda, solve_frustum_batch

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = [batch[k] for k in ("pc", "intensity", "sn", "node_a", "node_b",
                               "img")]

    def forward():
        coarse, fine = model(*args)
        return coarse, fine, torch.argmax(coarse, dim=-1)

    def solve(pred):
        return solve_frustum_batch(batch["pc"], pred, batch["K"], H=cfg.img_H,
                                   W=cfg.img_W, generator=gen,
                                   n_inits=N_INITS, max_iter=MAX_ITER,
                                   solver_stride=SOLVER_STRIDE)

    steps = 3
    _, _, pred = forward()                       # warm-up
    solve(pred)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.launches = 0
    lm_solve_cuda.launches = 0
    t = time.perf_counter()
    outs = []
    for _ in range(steps):
        coarse, fine, pred = forward()
        P, cost = solve(pred)
        outs.append((coarse, fine, P, cost))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"knn": knn_cuda.launches, "lm_solve_p4": lm_solve_cuda.launches}
    log(f"slice: launches {launches} in {steps} steps")
    require(launches["knn"] == 4 * steps,
            f"knn launches {launches['knn']} != {4 * steps}")
    require(launches["lm_solve_p4"] == 2 * steps,
            f"lm launches {launches['lm_solve_p4']} != {2 * steps}")
    B, N = batch["pc"].shape[:2]
    for i, (coarse, fine, P, cost) in enumerate(outs):
        require(tuple(coarse.shape) == (B, N, 2), "coarse logits shape")
        require(tuple(fine.shape) == (B, N, cfg.num_fine_classes),
                "fine logits shape")
        require(tuple(P.shape) == (B, 4, 4) and tuple(cost.shape) == (B,),
                "pose / cost shape")
        for name, x in (("coarse", coarse), ("fine", fine), ("P", P),
                        ("cost", cost)):
            bad = (~torch.isfinite(x)).reshape(B, -1).any(1).nonzero().flatten()
            require(bad.numel() == 0,
                    f"step {i}: non-finite {name} in pairs {bad.tolist()}")
    peak = torch.cuda.max_memory_allocated()
    inside = float(outs[-1][0].argmax(-1).float().mean())

    fwd_ms = cuda_ms(torch, forward, steps)
    solve_ms = cuda_ms(torch, lambda: solve(pred), steps)
    log(f"slice: {steps} steps of B={B} in {dt:.4f} s -> "
        f"{steps * B / dt:.2f} pairs/s; forward {fwd_ms:.3f} ms, solve "
        f"{solve_ms:.3f} ms per batch (CUDA events); peak memory "
        f"{peak / 2**30:.3f} GiB; predicted-inside share {inside:.3f}; "
        f"card {torch.cuda.get_device_name(0)}")
    return launches


def kitti_eval_batch(torch, seed: int = 0):
    """The evaluation path's batch: ``config.kitti`` street scenes at B=8,
    N=20480, 160x512, with the ray-cast dense depth the pseudo clouds come
    from (numpy, host side)."""
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import synthetic_batch

    cfg = config.kitti(synthetic_scene="street", batch_size=EVAL_BATCH)
    return cfg, synthetic_batch(cfg, seed=seed, with_depth=True,
                                dense_depth=True)


def nn1_phase(torch, raw):
    """The 1-NN kernel at the ICP path's launch shape (every pair x init of
    the evaluation batch against the pairs' pseudo clouds, as
    ``icp_batch`` calls it), at one init group against one cloud with
    sentinel rows and a ragged last tile, and one ICP batch under
    ``torch.profiler``."""
    from deepi2p_tpu_torch.ops import nn1_plain
    from deepi2p_tpu_torch.ops.knn_cuda import nn1_cuda
    from deepi2p_tpu_torch.register.icp import (_draw_inits, _transform,
                                                depth_to_pointcloud)

    source = torch.from_numpy(raw["pc"]).cuda()
    B, N, D = source.shape
    target = torch.stack([depth_to_pointcloud(
        torch.from_numpy(raw["depth"][b]).cuda(),
        torch.from_numpy(raw["K"][b]).cuda(), stride=PSEUDO_STRIDE)
        for b in range(B)]).contiguous()
    M = target.shape[1]
    # the queries of an ICP iteration: every pair's 64 inits applied to
    # its source cloud, 64 query sets per pseudo cloud
    I = -(-ICP_INITS // 8) * 8
    P0 = _draw_inits(torch.Generator().manual_seed(5), (B, I),
                     (5.0, 0.0, 10.0), math.pi).cuda()
    q = _transform(source[:, None], P0[..., :3, :3], P0[..., :3, 3])
    q = q.reshape(B * I, N, D).contiguous()
    group = q[:NN1_SETS].contiguous()               # pair 0's first 8 inits
    padded = target[:1].clone()
    padded[:, 5000:] = 1e6                         # 5000 points + sentinels
    cases = [("icp launch", q, target), ("sentinel-padded", group, padded),
             ("M=5000", group, target[:1, :5000].contiguous())]
    row = dict(max_abs_err=0.0, library_ms=None)
    for name, qq, db in cases:
        d2_k, idx_k = nn1_cuda(qq, db)
        d2_p, idx_p = nn1_plain(qq, db)
        torch.cuda.synchronize()
        require(bool(torch.equal(idx_k, idx_p)),
                f"nn1 {name}: indices differ from the plain version at "
                f"{int((idx_k != idx_p).sum())} places")
        require(int(idx_k.min()) >= 0 and int(idx_k.max()) < db.shape[1],
                f"nn1 {name}: index out of range")
        if name == "sentinel-padded":
            require(int(idx_k.max()) < 5000,
                    "nn1: a sentinel row was chosen as a nearest neighbour")
        err = float((d2_k - d2_p).abs().max())
        log(f"nn1 {name}: S={qq.shape[0]} N={N} B={db.shape[0]} "
            f"M={db.shape[1]} d2 max abs err {err:.3g}, indices equal")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del d2_k, idx_k, d2_p, idx_p

    # times at the ICP launch shape; no single PyTorch call computes this
    # 1-NN there (cdist would hold 512 x 20480 x 5120 distances, 215 GB),
    # so the library call is timed at one init group against one cloud
    S = q.shape[0]
    row["ms"] = cuda_ms(torch, lambda: nn1_cuda(q, target), 5)
    row["plain_ms"] = cuda_ms(torch, lambda: nn1_plain(q, target), 1)
    ops = S * N * M * ((3 * D - 1) + 1)   # distance, then one compare
    nbytes = 4 * (S * N * D + B * M * D) + 8 * S * N
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"nn1 icp launch: S={S} N={N} B={B} M={M} D={D} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
        f"(bytes {t_bytes:.5f}, operations {t_ops:.5f})")
    db1 = target[:1]
    g_ms = cuda_ms(torch, lambda: nn1_cuda(group, db1), 10)
    g_lib = cuda_ms(torch, lambda: torch.min(torch.cdist(
        group, db1.expand(NN1_SETS, -1, -1),
        compute_mode="donot_use_mm_for_euclid_dist"), dim=-1), 2)
    log(f"nn1 init group: S={NN1_SETS} N={N} M={M} ms={g_ms:.4f} "
        f"cdist+min ms={g_lib:.4f}")
    icp_profile(torch, source, target)
    return row


def icp_profile(torch, source, target):
    """One ICP batch of the evaluation path (the ``icp`` method's
    ``icp_batch`` call), timed by the host clock after a warm-up, then
    under ``torch.profiler``: device time of the 1-NN kernel, the SVD, the
    determinant, the gathers and the rest."""
    from torch.autograd import DeviceType
    from deepi2p_tpu_torch.register.icp import icp_batch

    def run():
        return icp_batch(source, target, torch.Generator().manual_seed(0),
                         n_inits=ICP_INITS, max_iter=ICP_ITERS, device="cuda")

    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t

    def dev_us(e):
        for key in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(e, key, None) is not None:
                return float(getattr(e, key))
        return 0.0

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        log(f"icp batch: wall {wall:.4f} s; the trace holds no device time "
            f"(split not measured)")
        return
    groups = (("nn1 kernel", ("nn1_kernel",)),
              ("svd", ("svd", "jacobi", "gesvd", "syevj")),
              ("det (LU)", ("getrf", "lu_", "det")), ("gather", ("gather",)))
    split = {name: [0.0, 0] for name, _ in groups}
    split["rest"] = [0.0, 0]
    for e in events:
        key = e.key.lower()
        name = next((n for n, pats in groups
                     if any(p in key for p in pats)), "rest")
        split[name][0] += dev_us(e) / 1e3
        split[name][1] += e.count
    busy = sum(v[0] for v in split.values())
    log(f"icp batch: B={source.shape[0]} N={source.shape[1]} "
        f"M={target.shape[1]} {ICP_INITS} inits {ICP_ITERS} iterations: "
        f"wall {wall:.4f} s; profiled wall {wall_prof * 1e3:.3f} ms, device "
        f"busy {busy:.3f} ms; split " + ", ".join(
            f"{n} {ms:.3f} ms ({100 * ms / busy:.1f}%, {c} launches)"
            for n, (ms, c) in split.items()))


def lm6_phase(torch, batch, cfg, pred):
    """The 6-DoF LM kernel at the 6-DoF solve's probe and refine shapes:
    the model's labels, the true pose's, and zero-angle inits."""
    from deepi2p_tpu_torch.register import (initial_guess, lm_solve_cuda,
                                            lm_solve_plain, sample_inits)

    kw = dict(H=cfg.img_H, W=cfg.img_W)
    t_lb, t_ub = (-5.0, -0.1, -10.0), (5.0, 0.1, 10.0)
    pc, K = batch["pc"], batch["K"].contiguous()
    truth = frustum_labels(torch, pc, batch["P"], batch["K"], cfg.img_H,
                           cfg.img_W)
    s, ps = SOLVER_STRIDE, max(1, 4 // SOLVER_STRIDE)
    keep = max((N_INITS // 8) // 8 * 8, 8)

    def sub(x, stride):
        return x[:, ::stride].contiguous()

    row = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               max_abs_err=0.0, bound_by=None)
    for lab_name, labels, zero_angle in (("truth", truth, False),
                                         ("model", pred, False),
                                         ("truth, zero angles", truth, True)):
        ang, valid = initial_guess(pc, labels)
        gen = torch.Generator(device=pc.device).manual_seed(2)
        theta = sample_inits(gen, ang, N_INITS, is_2d=False)
        if zero_angle:
            theta[..., :3] = 0.0
        theta = theta.contiguous()
        full = [sub(x, s) for x in (pc, labels.float(), valid)]
        probe = [sub(x, ps) for x in full]
        for name, inputs, iters in (("probe", probe, PROBE_ITER),
                                    ("refine", full, MAX_ITER - PROBE_ITER)):
            args = (*inputs, K, theta, t_lb, t_ub)
            th_p, c_p, terr = compare_lm(
                torch, f"6-DoF {name} ({lab_name} labels)", args,
                dict(kw, max_iter=iters))
            nonfinite_cost_points(torch, f"6-DoF {name} ({lab_name} "
                                  f"labels)", args, c_p, **kw)
            row["max_abs_err"] = max(row["max_abs_err"], terr)
            if lab_name == "model":
                ms = cuda_ms(torch, lambda: lm_solve_cuda(
                    *args, max_iter=iters, **kw), 5)
                plain_ms = cuda_ms(torch, lambda: lm_solve_plain(
                    *args, max_iter=iters, **kw), 1)
                B, N, _ = inputs[0].shape
                I = theta.shape[1]
                bound, row["bound_by"] = lm_bound(inputs, I, iters, 6)
                log(f"lm6 {name}: B={B} N={N} I={I} iters={iters} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound:.5f}")
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["bound_ms"] += bound
            if name == "probe":
                top = torch.argsort(c_p, dim=1, stable=True)[:, :keep]
                theta = torch.gather(
                    th_p, 1, top[:, :, None].expand(-1, -1, 6)).contiguous()
    return row


def nonfinite_cost_points(torch, tag, args, cost, *, H: int,
                          W: int) -> None:
    """Name the points behind each non-finite cost of a 6-DoF LM run.

    A non-finite cost is never replaced (a proposal is taken only if its
    cost is below the current one), so it is the cost of the clipped
    init: the per-point cost terms at that theta show which points are
    not finite."""
    from deepi2p_tpu_torch.register.frustum_cuda import (_clip_t,
                                                         _residual_parts,
                                                         _rot6)

    pts, lab, val, K, theta0, t_lb, t_ub = args
    for b, i in (~torch.isfinite(cost)).nonzero().tolist()[:4]:
        th = _clip_t(theta0[b:b + 1, i:i + 1], t_lb, t_ub)      # (1, 1, 6)
        R, _ = _rot6(th)
        x, y, z = (pts[b, :, d] for d in range(3))
        p = [R[3 * r][0, 0] * x + R[3 * r + 1][0, 0] * y
             + R[3 * r + 2][0, 0] * z + th[0, 0, 3 + r] for r in range(3)]
        inv_z = 1.0 / p[2]
        px = K[b, 0, 0] * p[0] * inv_z + K[b, 0, 2]
        py = K[b, 1, 1] * p[1] * inv_z + K[b, 1, 2]
        r0_in, _, r1_in, _, r2_in, _, r_out, _, _, _ = _residual_parts(
            px, py, p[2], float(H - 1), float(W - 1))
        inn = lab[b] > 0.5
        zero = torch.zeros((), device=pts.device)
        r0 = torch.where(inn, r0_in, r_out) * val[b]
        r1 = torch.where(inn, r1_in, zero) * val[b]
        r2 = torch.where(inn, r2_in, zero) * val[b]
        term = 0.5 * torch.log1p(r0 * r0 + r1 * r1 + r2 * r2) * val[b]
        bad = (~torch.isfinite(term)).nonzero().flatten().tolist()
        log(f"lm {tag}: cost {float(cost[b, i])} at pair {b} init {i}, "
            f"theta {[float(v) for v in th[0, 0]]}: non-finite cost terms "
            f"at points {bad[:8]} of {len(bad)}")
        for n in bad[:8]:
            log(f"  point {n}: xyz {[float(v) for v in pts[b, n]]} label "
                f"{float(lab[b, n])} valid {float(val[b, n])} p "
                f"{[float(v[n]) for v in p]} px {float(px[n])} py "
                f"{float(py[n])} r0 {float(r0[n])} r1 {float(r1[n])} r2 "
                f"{float(r2[n])} term {float(term[n])}")


def solve6_phase(torch, model, batch, cfg):
    """forward -> argmax -> the 6-DoF solve, at the main path's settings."""
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda
    from deepi2p_tpu_torch.register import (lm_solve_cuda, pose_diff,
                                            registration_summary,
                                            solve_frustum_batch)

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = [batch[k] for k in ("pc", "intensity", "sn", "node_a", "node_b",
                               "img")]

    def solve(pred):
        return solve_frustum_batch(batch["pc"], pred, batch["K"], H=cfg.img_H,
                                   W=cfg.img_W, generator=gen,
                                   n_inits=N_INITS, max_iter=MAX_ITER,
                                   solver_stride=SOLVER_STRIDE, is_2d=False)

    steps = 3
    solve(torch.argmax(model(*args)[0], dim=-1))      # warm-up
    torch.cuda.synchronize()
    knn_cuda.launches = 0
    lm_solve_cuda.launches = 0
    lm_solve_cuda.launches_p6 = 0
    t = time.perf_counter()
    outs = []
    for _ in range(steps):
        pred = torch.argmax(model(*args)[0], dim=-1)
        outs.append(solve(pred))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"knn": knn_cuda.launches, "lm_p4": lm_solve_cuda.launches,
                "lm_p6": lm_solve_cuda.launches_p6}
    log(f"solve6: launches {launches} in {steps} steps")
    require(launches["lm_p6"] == 2 * steps,
            f"6-DoF LM launches {launches['lm_p6']} != {2 * steps}")
    require(launches["knn"] == 4 * steps,
            f"knn launches {launches['knn']} != {4 * steps}")
    require(launches["lm_p4"] == 0, "the 6-DoF solve ran the 2-D LM")
    B = batch["pc"].shape[0]
    for i, (P, cost) in enumerate(outs):
        require(tuple(P.shape) == (B, 4, 4) and tuple(cost.shape) == (B,),
                "6-DoF pose / cost shape")
        require(bool(torch.isfinite(P).all() and torch.isfinite(cost).all()),
                f"step {i}: non-finite 6-DoF pose or cost")
    solve_ms = cuda_ms(torch, lambda: solve(pred), steps)
    truth = frustum_labels(torch, batch["pc"], batch["P"], batch["K"],
                           cfg.img_H, cfg.img_W)
    P_t, _ = solve(truth)
    P_gt = torch.eye(4, device=P_t.device).repeat(B, 1, 1)
    P_gt[:, :3] = batch["P"]
    rte, rre = pose_diff(P_t.double(), P_gt.double())
    summ = registration_summary(rte.cpu().numpy(), rre.cpu().numpy())
    log(f"solve6: {steps} steps of B={B} in {dt:.4f} s -> "
        f"{steps * B / dt:.2f} pairs/s (forward + 6-DoF solve); solve "
        f"{solve_ms:.3f} ms per batch (CUDA events); from the true pose's "
        f"labels: success rate {summ['success_rate']:.4f}, RTE mean "
        f"{summ['rte_mean']:.4f} m, RRE mean {summ['rre_mean']:.4f} deg")
    return launches


def eval_phase(torch, cfg, raw):
    """The evaluation path end to end, over a dump the port's detector
    writes, at the KITTI shape."""
    from deepi2p_tpu_torch.eval.depth import dump_pseudo_pointclouds
    from deepi2p_tpu_torch.eval.dump import dump_predictions
    from deepi2p_tpu_torch.eval.harness import evaluate_registration
    from deepi2p_tpu_torch.models import build_detector
    from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda, nn1_cuda
    from deepi2p_tpu_torch.register import lm_solve_cuda

    model = build_detector(cfg, device="cuda", seed=0)
    B = raw["pc"].shape[0]
    with tempfile.TemporaryDirectory(prefix="deepi2p_eval_") as tmp:
        dump_dir, pseudo_dir = f"{tmp}/dump", f"{tmp}/pseudo"
        knn_cuda.launches = nn1_cuda.launches = 0
        lm_solve_cuda.launches = lm_solve_cuda.launches_p6 = 0
        t = time.perf_counter()
        acc = dump_predictions(model, [raw], cfg, dump_dir)
        torch.cuda.synchronize()
        log(f"eval: dump_predictions {time.perf_counter() - t:.4f} s, "
            f"coarse/fine accuracy {acc[0]:.4f}/{acc[1]:.4f}")
        t = time.perf_counter()
        items = [(f"{b:06d}_00", raw["depth"][b]) for b in range(B)]
        dump_pseudo_pointclouds(items, raw["K"][0], lambda d: d, pseudo_dir,
                                stride=PSEUDO_STRIDE, device="cuda")
        log(f"eval: dump_pseudo_pointclouds {time.perf_counter() - t:.4f} s")
        kw = dict(H=cfg.img_H, W=cfg.img_W, batch_size=B, device="cuda")
        runs = [("icp", dict(method="icp", n_inits=ICP_INITS,
                             max_iter=ICP_ITERS, pseudo_dir=pseudo_dir)),
                ("frustum (labels)", dict(method="frustum", use_labels=True)),
                ("frustum (predictions)", dict(method="frustum")),
                ("random", dict(method="random"))]
        counts = {}
        for name, args in runs:
            before = (nn1_cuda.launches, lm_solve_cuda.launches)
            t = time.perf_counter()
            summ = evaluate_registration(dump_dir, **kw, **args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts[name] = (nn1_cuda.launches - before[0],
                            lm_solve_cuda.launches - before[1])
            log(f"eval {name}: wall {wall:.4f} s, launches (nn1, lm_p4) "
                f"{counts[name]}, summary {json.dumps(summ)}")
            require(summ["num_pairs"] == B, f"eval {name}: pair count")
            for key in ("rte_mean", "rre_mean", "success_rate"):
                require(math.isfinite(summ[key]),
                        f"eval {name}: non-finite {key}")
    launches = {"knn": knn_cuda.launches, "nn1": nn1_cuda.launches,
                "lm_p4": lm_solve_cuda.launches}
    log(f"eval: launches {launches}")
    require(counts["icp"][0] >= ICP_ITERS + 1,
            f"nn1 launches per ICP batch {counts['icp'][0]} < "
            f"{ICP_ITERS + 1}")
    require(launches["knn"] > 0, "the dump's forward launched no kNN")
    require(launches["lm_p4"] > 0, "the frustum method launched no 2-D LM")
    return launches


def reference_phase(torch):
    from deepi2p_tpu_torch import config
    from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
    from deepi2p_tpu_torch.models import build_detector
    from deepi2p_tpu_torch.register import sample_inits, initial_guess
    from deepi2p_tpu_torch.register import solve_frustum_batch

    cfg = config.tiny()                          # f32 compute dtype
    raw = synthetic_batch(cfg, seed=3)
    outs = {}
    for dev in ("cpu", "cuda"):
        b = batch_to_torch(raw, device=dev)
        model = build_detector(cfg, device=dev, seed=0)
        coarse, fine = model(b["pc"], b["intensity"], b["sn"], b["node_a"],
                             b["node_b"], b["img"])
        outs[dev] = (b, coarse, fine)
    b_cpu, c_cpu, f_cpu = outs["cpu"]
    b_gpu, c_gpu, f_gpu = outs["cuda"]
    scale = max(float(c_cpu.abs().max()), float(f_cpu.abs().max()), 1e-6)
    err = max(float((c_gpu.cpu() - c_cpu).abs().max()),
              float((f_gpu.cpu() - f_cpu).abs().max())) / scale
    log(f"reference: logits max rel err card vs CPU {err:.3g}")
    require(err <= REF_LOGIT_RTOL, f"reference logits rel err {err:.3g}")

    pred = c_cpu.argmax(-1)
    ang, _ = initial_guess(b_cpu["pc"], pred)
    theta0 = sample_inits(torch.Generator().manual_seed(0), ang, N_INITS)
    res = {}
    for dev, b in (("cpu", b_cpu), ("cuda", b_gpu)):
        P, cost = solve_frustum_batch(
            b["pc"], pred.to(dev), b["K"], H=cfg.img_H, W=cfg.img_W,
            theta0=theta0.to(dev), max_iter=MAX_ITER,
            solver_stride=SOLVER_STRIDE)
        res[dev] = (P.cpu(), cost.cpu())
    theta6 = sample_inits(torch.Generator().manual_seed(0), ang, N_INITS,
                          is_2d=False)
    res6 = {}
    for dev, b in (("cpu", b_cpu), ("cuda", b_gpu)):
        P, cost = solve_frustum_batch(
            b["pc"], pred.to(dev), b["K"], H=cfg.img_H, W=cfg.img_W,
            theta0=theta6.to(dev), max_iter=MAX_ITER,
            solver_stride=SOLVER_STRIDE, is_2d=False)
        res6[dev] = (P.cpu(), cost.cpu())
    for tag, r in (("2-D", res), ("6-DoF", res6)):
        perr = float((r["cuda"][0] - r["cpu"][0]).abs().max())
        crel = float(((r["cuda"][1] - r["cpu"][1]).abs()
                      / r["cpu"][1].abs().clamp(min=1e-6)).max())
        log(f"reference: {tag} solve pose max abs err {perr:.3g}, cost max "
            f"rel err {crel:.3g}")
        require(perr <= REF_POSE_ATOL, f"reference {tag} pose err {perr:.3g}")
        require(crel <= LM_COST_RTOL,
                f"reference {tag} cost rel err {crel:.3g}")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    with phase("device"):
        if not torch.cuda.is_available():
            raise CheckFailed("no CUDA device (torch.cuda.is_available() is "
                              "False)")
        smi = nvidia_smi()
        log(f"card: {smi}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        # f32 comparisons below must be true f32: no TF32 in matmuls or
        # cuDNN convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from deepi2p_tpu_torch import _build, config
    from deepi2p_tpu_torch.data import batch_to_torch, synthetic_batch
    from deepi2p_tpu_torch.models import build_detector

    with phase("build"):
        t = time.perf_counter()
        _build.build(verbose=True)
        _build.load_library()
        log(f"build: {time.perf_counter() - t:.1f} s")

    cfg = config.oxford(batch_size=BATCH)
    with phase("data"):
        batch = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")

    with torch.no_grad():
        with phase("model"):
            model = build_detector(cfg, device="cuda", seed=0)
            coarse, _ = model(*(batch[k] for k in (
                "pc", "intensity", "sn", "node_a", "node_b", "img")))
            pred = torch.argmax(coarse, dim=-1)
        with phase("knn"):
            knn_row = knn_phase(torch, batch, cfg)
        with phase("lm"):
            lm_row = lm_phase(torch, batch, cfg, pred)
        with phase("slice"):
            launches = slice_phase(torch, model, batch, cfg)
        with phase("nn1"):
            eval_cfg, eval_raw = kitti_eval_batch(torch)
            nn1_row = nn1_phase(torch, eval_raw)
        with phase("lm6"):
            lm6_row = lm6_phase(torch, batch, cfg, pred)
        with phase("solve6"):
            launches6 = solve6_phase(torch, model, batch, cfg)
        del model
        torch.cuda.empty_cache()
        with phase("eval"):
            launches_eval = eval_phase(torch, eval_cfg, eval_raw)
        with phase("reference"):
            reference_phase(torch)

    lm_src = "deepi2p_tpu_torch/csrc/frustum_lm.cu"
    kernels = [
        dict(name="knn", route="cuda", source="deepi2p_tpu_torch/csrc/knn.cu",
             replaces="deepi2p_tpu/ops/knn_pallas.py:60",
             launches=launches["knn"], **knn_row),
        dict(name="lm_p4", route="cuda", source=lm_src,
             replaces="deepi2p_tpu/register/frustum_pallas.py:336",
             launches=launches["lm_solve_p4"], **lm_row),
        dict(name="lm_p6", route="cuda", source=lm_src,
             replaces="deepi2p_tpu/register/frustum_pallas.py:336",
             launches=launches6["lm_p6"], **lm6_row),
        dict(name="nn1", route="cuda", source="deepi2p_tpu_torch/csrc/nn1.cu",
             replaces="deepi2p_tpu/ops/knn_pallas.py:141",
             launches=launches_eval["nn1"], **nn1_row),
    ]
    log("kernels=" + json.dumps([k["name"] for k in kernels]))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"CHECK FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
