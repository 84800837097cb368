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
2. ``build``: one ``nvcc`` call over ``deepi2p_tpu_torch/csrc/*.cu``.
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
8. ``reference``: a small input (``config.tiny()``, f32) through the card
   path and the CPU path (the plain versions, which the CPU tests hold to
   the JAX package): logits and solved poses must agree.

Then a ``kernels=`` line, one JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  A watchdog ends a hung run after
420 s with a traceback and a nonzero exit; any failed check exits nonzero
before the last line is printed.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import subprocess
import sys
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


def lm_phase(torch, batch, cfg, pred):
    """The LM kernel at the solve's probe and refine shapes, on the main
    path's own inputs (the seeded model's labels) and on the labels of
    the true pose."""
    from deepi2p_tpu_torch.register import (initial_guess, lm_solve_cuda,
                                            lm_solve_plain, sample_inits)
    from deepi2p_tpu_torch.register.frustum_cuda import LM_OPS_PER_POINT

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
                ops = LM_OPS_PER_POINT * B * I * N * (iters + 1)
                nbytes = 4 * (5 * B * N + 9 * B + 9 * B * I)
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_ops = ops / PEAK_F32_OPS * 1e3
                bound = max(t_bytes, t_ops)
                log(f"lm {name}: B={B} N={N} I={I} iters={iters} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound:.5f}")
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["bound_ms"] += bound
                row["bound_by"] = ("operations" if t_ops >= t_bytes
                                   else "bytes")
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
    perr = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    crel = float(((res["cuda"][1] - res["cpu"][1]).abs()
                  / res["cpu"][1].abs().clamp(min=1e-6)).max())
    log(f"reference: solve pose max abs err {perr:.3g}, cost max rel err "
        f"{crel:.3g}")
    require(perr <= REF_POSE_ATOL, f"reference pose err {perr:.3g}")
    require(crel <= LM_COST_RTOL, f"reference cost rel err {crel:.3g}")


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
        with phase("reference"):
            reference_phase(torch)

    kernels = [
        dict(name="knn", route="cuda", source="deepi2p_tpu_torch/csrc/knn.cu",
             replaces="deepi2p_tpu/ops/knn_pallas.py:60",
             launches=launches["knn"], **knn_row),
        dict(name="lm_solve_p4", route="cuda",
             source="deepi2p_tpu_torch/csrc/frustum_lm.cu",
             replaces="deepi2p_tpu/register/frustum_pallas.py:336",
             launches=launches["lm_solve_p4"], **lm_row),
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
