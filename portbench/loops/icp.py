"""ICP: closed loop, one batch in flight, as ``eval.cli solve --method
icp`` runs it: each batch of LiDAR clouds and their pseudo clouds (ray-cast
depth at the traffic's stride, calibrated to the true frustum's mean
depth) goes through ``icp_batch`` at its defaults, the inits drawn from a
CPU generator seeded per batch; the batch ends when its poses and fitness
are on the host.  Every answer is kept (a few floats); the check takes
one pair of each slot of the batch, each from another window batch drawn
from the seed, so that every slot is compared.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench.reference import icp as ref_icp
from portbench.traffic import synthetic

INIT_CHUNK = 8


def setup(ctx: harness.Ctx):
    from deepi2p_tpu_torch.register.icp import icp_batch

    t = ctx.traffic
    pool = [harness.to_device({"source": b["pc"], "target": b["target"]},
                              ctx.device)
            for b in synthetic.pool(ctx.cfg, t, ctx.seed)]
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = SimpleNamespace(ctx=ctx, pool=pool, icp=icp_batch, answers=[],
                         failed=0)
    for _ in range(t["warmup"]):
        batch(st, -1, keep=False)
    return st


def batch(st, i: int, keep: bool = True) -> int:
    ctx, t = st.ctx, st.ctx.traffic
    b = st.pool[i % len(st.pool)]
    gen = torch.Generator().manual_seed(harness.batch_seed(ctx.seed,
                                                           max(i, 0)))
    with ctx.spans("icp_batch"):
        res = st.icp(b["source"], b["target"], gen, n_inits=t["n_inits"],
                     threshold=t["threshold"], max_iter=t["max_iter"],
                     device=ctx.device)
    with ctx.spans("host_read"):
        P, fit = res.P.cpu(), res.fitness.cpu()
    B = P.shape[0]
    if keep:
        bad = ~(torch.isfinite(P).reshape(B, -1).all(1) & torch.isfinite(fit))
        st.failed += int(bad.sum())
        st.answers.append((i, P, fit))
    return B


def finish(st) -> None:
    pass


def profiled(st, start: int, n: int) -> dict:
    for k in range(n):
        batch(st, start + k, keep=False)
    return {}


def _answer(st, i, j, control):
    """(P, fitness) of pair j of batch i by the reference, all its inits:
    float32, or the control's precision; and every init's (P, fitness)."""
    ctx, t = st.ctx, st.ctx.traffic
    b = st.pool[i % len(st.pool)]
    B = b["source"].shape[0]
    n = -(-t["n_inits"] // INIT_CHUNK) * INIT_CHUNK
    gen = torch.Generator().manual_seed(harness.batch_seed(ctx.seed, i))
    P0 = ref_icp.inits(gen, B, n)[j].to(ctx.device)
    P, fit = ref_icp.icp(b["source"][j], b["target"][j], P0,
                         iters=t["max_iter"], threshold=t["threshold"],
                         dtype=torch.bfloat16 if control else torch.float32)
    return ref_icp.pick(P, fit), (P, fit)


def picks(batches, B: int, seed: int) -> list:
    """(batch, slot) of the pairs the check compares: slot j of the j-th
    batch of a permutation of ``batches`` drawn from the seed (cycled
    where the window has fewer batches than slots)."""
    rng = np.random.default_rng(synthetic.derived_seed(seed, harness.SAMPLE))
    order = [batches[k] for k in rng.permutation(len(batches))]
    return [(order[j % len(order)], j) for j in range(B)]


def check(st, control=None) -> dict:
    """Over the sampled pairs, one of each slot: ``icp_fitness_gap``, the
    worst pair's fitness against the reference's best; ``icp_pose_gap``,
    the worst pair's largest entry of the difference between its pose and
    the nearest of the reference's flattened poses, one per init."""
    ctx = st.ctx
    harness.free_device_memory()
    by_batch = {i: (P, fit) for i, P, fit in st.answers}
    B = st.pool[0]["source"].shape[0]
    nums = dict(icp_fitness_gap=0.0, icp_pose_gap=0.0)
    with harness.reference_numerics():
        for i, j in picks(sorted(by_batch), B, ctx.seed):
            if control is None:
                P_p, f_p = by_batch[i][0][j], float(by_batch[i][1][j])
            else:
                (P_c, f_c), _ = _answer(st, i, j, control)
                P_p, f_p = P_c.cpu(), float(f_c)
            (_, f_best), (P_all, f_all) = _answer(st, i, j, None)
            nums["icp_fitness_gap"] = max(nums["icp_fitness_gap"],
                                          abs(f_p - float(f_best)))
            cand = (torch.eye(4)[None] if f_p <= 0.001
                    else ref_icp.flatten(P_all).cpu())
            gap = float((cand - P_p).abs().amax(dim=(1, 2)).min())
            nums["icp_pose_gap"] = max(nums["icp_pose_gap"], gap)
    return nums
