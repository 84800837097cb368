"""Registration: closed loop, one batch in flight.

Each batch of the pool (cycled) goes through the detector's forward in
eval mode, the argmax of the coarse logits and ``solve_frustum_batch``
(2-D); it ends when its poses and costs are on the host.  A reservoir
drawn from the seed keeps ``check_pairs`` of the window's pairs: their
logits, labels, poses and costs, which the check holds to the reference.
"""
from __future__ import annotations

import math
import statistics
from types import SimpleNamespace

import torch

from portbench import harness
from portbench.reference import detector as ref
from portbench.reference import frustum as ref_solve
from portbench.traffic import synthetic

INPUTS = ("pc", "intensity", "sn", "node_a", "node_b", "img")


def setup(ctx: harness.Ctx):
    from deepi2p_tpu_torch.register import solve_frustum_batch

    t = ctx.traffic
    pool = [harness.to_device(b, ctx.device)
            for b in synthetic.pool(ctx.cfg, t, ctx.seed)]
    sd = ref.make_state(ctx.cfg, synthetic.derived_seed(ctx.seed,
                                                        harness.WEIGHTS),
                        ctx.device)
    calib = [pool[0][k][:t["calib_pairs"]] for k in INPUTS]
    with harness.reference_numerics():
        ref.calibrate(sd, ctx.cfg, calib)
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = SimpleNamespace(
        ctx=ctx, pool=pool, sd=sd,
        model=harness.build_model(ctx.port, sd, ctx.device),
        solve=solve_frustum_batch,
        gen=torch.Generator(device=ctx.device),
        sample=harness.Reservoir(t["check_pairs"], ctx.seed),
        failed=0, preds=None)
    for w in range(t["warmup"]):
        batch(st, -1, keep=False)
    return st


def batch(st, i: int, keep: bool = True) -> int:
    """Batch ``i`` of the window (``i < 0``: warm-up); returns its pairs."""
    ctx, t, spans = st.ctx, st.ctx.traffic, st.ctx.spans
    b = st.pool[i % len(st.pool)]
    with torch.no_grad():
        with spans("forward"):
            coarse, fine = st.model(*(b[k] for k in INPUTS))
        with spans("argmax"):
            pred = torch.argmax(coarse, dim=-1)
        st.gen.manual_seed(harness.batch_seed(ctx.seed, max(i, 0)))
        with spans("solve"):
            P, cost = st.solve(b["pc"], pred, b["K"], H=ctx.cfg["img_H"],
                               W=ctx.cfg["img_W"], generator=st.gen,
                               n_inits=t["n_inits"], max_iter=t["max_iter"],
                               solver_stride=t["solver_stride"],
                               backend=t["backend"])
        with spans("host_read"):
            P, cost = P.cpu(), cost.cpu()
    B = P.shape[0]
    if keep:
        bad = ~(torch.isfinite(P).reshape(B, -1).all(1) & torch.isfinite(cost))
        st.failed += int(bad.sum())
        for j, slot in st.sample.slots(B):
            st.sample.items[slot] = dict(
                i=i, j=j, coarse=coarse[j].clone(), fine=fine[j].clone(),
                pred=pred[j].clone(), P=P[j], cost=cost[j])
    if st.preds is not None:
        st.preds.append(pred)
    return B


def finish(st) -> None:
    pass


def profiled(st, start: int, n: int) -> dict:
    """Runs ``n`` batches (under the caller's profiler) and returns what
    the LM's roofline needs: each launch's inside and outside labels, its
    inits and iterations."""
    st.preds = []
    for k in range(n):
        batch(st, start + k, keep=False)
    t = st.ctx.traffic
    s = t["solver_stride"]
    ps = max(1, 4 // s)
    I = -(-t["n_inits"] // 8) * 8
    probe = min(8, t["max_iter"])
    launches = []
    for pred in st.preds:
        lab = pred[:, ::s]
        for labels, inits, iters in ((lab[:, ::ps], I, probe),
                                     (lab, max(I // 8 // 8 * 8, 8),
                                      t["max_iter"] - probe)):
            n_in = int(labels.sum())
            launches.append((n_in, labels.numel() - n_in, inits, iters))
    st.preds = None
    return {"lm_launches": launches}


def _stacked(st, items):
    """The sampled pairs' inputs, stacked: {key: (S, ...)}."""
    rows = [(st.pool[x["i"] % len(st.pool)], x["j"]) for x in items]
    return {k: torch.cat([b[k][j:j + 1] for b, j in rows])
            for k in (*INPUTS, "K")}


def _inits(st, items, pc, pred):
    """Each sampled pair's inits as its batch drew them (the batch's
    normals, then its uniforms, from the batch's seed; the pair's row)
    around the yaw of its labels: (S, I, 4)."""
    ctx, t = st.ctx, st.ctx.traffic
    ang, _ = ref_solve.initial_guess(pc.float(), pred)
    rows = []
    for x in items:
        B = st.pool[x["i"] % len(st.pool)]["pc"].shape[0]
        gen = torch.Generator(device=ctx.device).manual_seed(
            harness.batch_seed(ctx.seed, x["i"]))
        kw = dict(generator=gen, device=gen.device)
        noise = torch.randn(B, t["n_inits"], **kw)[x["j"]]
        u = torch.rand(B, t["n_inits"], **kw)[x["j"]]
        rows.append((noise, u))
    noise = torch.stack([r[0] for r in rows])
    u = torch.stack([r[1] for r in rows])
    ry = ang[:, None] + ref_solve.RY_SIGMA * noise
    tz = (u * 2.0 - 1.0) * ref_solve.INIT_T
    z = torch.zeros_like(ry)
    return torch.stack([ry, z, z, tz], dim=-1)


def _outputs(st, items, x, control):
    """(coarse, fine, labels, P, cost) of the sampled pairs: the
    program's, or the reference's put in its place: under ``"control"``
    at the next lower precision (a float8 forward, a bfloat16 LM), under
    ``"unchanged"`` with an LM that leaves its inits as they are (a
    fault)."""
    if control is None:
        return tuple(torch.stack([it[k].to(st.ctx.device) for it in items])
                     for k in ("coarse", "fine", "pred", "P", "cost"))
    ctx, t = st.ctx, st.ctx.traffic
    low = control == "control"
    coarse, fine = ref.forward(st.sd, ctx.cfg, [x[k] for k in INPUTS],
                               quant=ref.fp8_quant if low else None)
    pred = coarse.argmax(-1)
    P, cost = ref_solve.solve(
        x["pc"], pred, x["K"], _inits(st, items, x["pc"], pred),
        H=ctx.cfg["img_H"], W=ctx.cfg["img_W"],
        max_iter=t["max_iter"] if low else 0,
        solver_stride=t["solver_stride"],
        dtype=torch.bfloat16 if low else torch.float32)
    return coarse, fine, pred, P, cost


def check(st, control=None) -> dict:
    """The numbers held to the cell's limits, over the sampled pairs, the
    reference run on all of them at once: ``coarse_logit_gap`` and
    ``fine_logit_gap``, the worst pair's relative 2-norm distance of the
    logits from the reference's; ``solve_excess``, the worst pair's cost
    above the reference solve's from the same labels and inits, relative,
    and ``solve_excess_median`` the median pair's; ``pose_cost_gap``, the
    worst pair's returned cost against the reference's cost at the
    returned pose, relative.  A cost is relative to the reference's, or
    to 1 (about one point's share) where that is smaller.  A pair with no
    inside label must get the identity and cost 1e4."""
    ctx, t = st.ctx, st.ctx.traffic
    st.model = None
    harness.free_device_memory()
    items = [it for it in st.sample.items if it is not None]
    with harness.reference_numerics():
        x = _stacked(st, items)
        coarse, fine, pred, P, cost = _outputs(st, items, x, control)
        r_coarse, r_fine = ref.forward(st.sd, ctx.cfg, [x[k] for k in INPUTS])
        kw = dict(H=ctx.cfg["img_H"], W=ctx.cfg["img_W"],
                  solver_stride=t["solver_stride"])
        _, c_ref = ref_solve.solve(x["pc"], pred, x["K"],
                                   _inits(st, items, x["pc"], pred),
                                   max_iter=t["max_iter"], **kw)
        c_at = ref_solve.cost_at(P, x["pc"], pred, x["K"], **kw)
    nums = dict(
        coarse_logit_gap=max(harness.rel_gap(a, b)
                             for a, b in zip(coarse, r_coarse)),
        fine_logit_gap=max(harness.rel_gap(a, b)
                           for a, b in zip(fine, r_fine)))
    excess, pose = [], []
    eye = torch.eye(4, device=P.device)
    for k in range(len(items)):
        c = float(cost[k])
        if int(pred[k].sum()) == 0:
            ok = torch.equal(P[k].float(), eye) and c == 1e4
            pose.append(0.0 if ok else math.inf)
            continue
        excess.append((c - float(c_ref[k])) / max(float(c_ref[k]), 1.0))
        gap = abs(c - float(c_at[k])) / max(float(c_at[k]), 1.0)
        pose.append(gap if math.isfinite(gap) else math.inf)
    nums["solve_excess"] = max([0.0, *excess])
    nums["solve_excess_median"] = (max(0.0, statistics.median(excess))
                                   if excess else 0.0)
    nums["pose_cost_gap"] = max(pose)
    return nums
