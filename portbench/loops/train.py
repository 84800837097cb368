"""Training: back-to-back ``Engine.train_step`` on a pool of batches
already on the card, cycled; no host read per step, the window ends in a
sync.

Set-up builds the one train state and drives it through its first three
steps by the window's own call, on three different batches, keeping what
the check compares: each step's loss, Adam's first moment after the first
step (the first gradient as the optimizer got it), and after the third the
parameters, Adam's second moment and the norms' running statistics.  The
window then continues from that same state.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List

import torch

from portbench import harness
from portbench.reference import detector as ref
from portbench.traffic import synthetic

INPUTS = ("pc", "intensity", "sn", "node_a", "node_b", "img")
STATS = (".running_mean", ".running_var")
FIRST = 3          # steps the reference follows
STEPS_PER_EPOCH = 1000   # the Engine's default, which sets the schedule
# leaves whose first reference gradient is under this share of the median
# leaf's move by round-off alone under Adam (a linear bias before a batch
# norm): they are left out of the parameters' change
ZERO_GRAD = 1e-3


def setup(ctx: harness.Ctx):
    from deepi2p_tpu_torch.train.engine import Engine, TrainState

    t = ctx.traffic
    pool = [harness.to_device(b, ctx.device)
            for b in synthetic.pool(ctx.cfg, t, ctx.seed)]
    if len(pool) < FIRST:
        raise ValueError(f"the train pool needs {FIRST} distinct batches")
    sd = ref.make_state(ctx.cfg, synthetic.derived_seed(ctx.seed,
                                                        harness.WEIGHTS),
                        ctx.device)
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = harness.build_model(ctx.port, sd, ctx.device)
    engine = Engine(ctx.port, steps_per_epoch=STEPS_PER_EPOCH,
                    device=ctx.device)
    state = TrainState(model, [], [])
    state.reset_optimizer()
    st = SimpleNamespace(ctx=ctx, pool=pool, sd=sd, engine=engine,
                         state=state, gen=torch.Generator(device=ctx.device),
                         names=[n for n, _ in model.named_parameters()],
                         losses=[], failed=0)
    st.train_step = engine.train_step
    for k in range(FIRST):
        step(st, k)
        if k == 0:
            st.mu1 = [m.clone() for m in state.mu]
    st.p3 = [p.detach().clone() for p in model.parameters()]
    st.nu3 = [v.clone() for v in state.nu]
    st.stats3 = {n: b.clone() for n, b in model.named_buffers()
                 if n.endswith(STATS)}
    st.first_losses = [float(x) for x in st.losses]
    st.losses = []
    return st


def step(st, i: int) -> int:
    b = st.pool[i % len(st.pool)]
    st.gen.manual_seed(harness.batch_seed(st.ctx.seed, i))
    with st.ctx.spans("train_step"):
        _, metrics = st.train_step(st.state, b, st.gen)
    st.losses.append(metrics["loss"])
    return b["pc"].shape[0]


def batch(st, i: int) -> int:
    """Window step ``i``: the state's step ``FIRST + i``."""
    return step(st, FIRST + i)


def finish(st) -> None:
    if st.losses:
        loss = torch.stack(st.losses)
        B = st.pool[0]["pc"].shape[0]
        st.failed += B * int((~torch.isfinite(loss)).sum())
        st.losses = []


def profiled(st, start: int, n: int) -> dict:
    for k in range(n):
        batch(st, start + k)
    finish(st)
    return {}


def _reference_steps(st, quant=None, half: bool = False, lr_sign=1.0):
    """The first three steps by the reference from the benchmark's
    weights: (losses, first gradients, and after the third the
    parameters, Adam's second moments, in the program's leaf order, and
    the running statistics by name).  ``half`` trains on the first half
    of each batch, ``lr_sign`` -1 steps up the gradient (faults)."""
    ctx = st.ctx
    params = {n: st.sd[n].clone().requires_grad_(True) for n in st.names}
    buffers = {n: v.clone() for n, v in st.sd.items() if n not in params}
    mom = ctx.cfg["norm_momentum"]
    leaves = [params[n] for n in st.names]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    losses, g1 = [], None
    for k in range(FIRST):
        b = st.pool[k]
        inputs = [b[key] for key in INPUTS]
        P, K = b["P"], b["K"]
        if half:
            h = inputs[0].shape[0] // 2
            inputs = [x[:h] for x in inputs]
            P, K = P[:h], K[:h]
        gen = torch.Generator(device=ctx.device).manual_seed(
            harness.batch_seed(ctx.seed, k))
        stats = {}
        with torch.enable_grad():
            coarse, fine = ref.forward({**params, **buffers}, ctx.cfg, inputs,
                                       train=True, quant=quant, generator=gen,
                                       stats=stats)
            c_lab, f_lab = ref.labels(inputs[0], P, K, ctx.cfg)
            loss = ref.loss(coarse, fine, c_lab, f_lab, ctx.cfg)
            grads = torch.autograd.grad(loss, leaves)
        for p, (mean, var) in stats.items():
            for key, x in ((".running_mean", mean), (".running_var", var)):
                buffers[p + key] = ((1.0 - mom) * buffers[p + key]
                                    + mom * x.reshape(-1))
        losses.append(float(loss))
        if k == 0:
            g1 = [g.detach().clone() for g in grads]
        ref.adam(leaves, grads, mu, nu, k,
                 lr_sign * ref.learning_rate(ctx.cfg, k, STEPS_PER_EPOCH))
        del coarse, fine, grads, loss
    stats3 = {n: v for n, v in buffers.items() if n.endswith(STATS)}
    return losses, g1, [p.detach() for p in leaves], nu, stats3


def _leaf_gaps(prog: List[float], ref_: List[float], keep=None) -> list:
    """|prog - ref| / max(ref, median ref) of each kept leaf."""
    pairs = [(p, r) for k, (p, r) in enumerate(zip(prog, ref_))
             if keep is None or keep[k]]
    med = float(torch.tensor([r for _, r in pairs]).median())
    return [abs(p - r) / max(r, med) for p, r in pairs]


def _norms(ts) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def check(st, control=None) -> dict:
    """``loss_gap``: the worst of the three steps' relative loss gaps,
    ``loss1_gap`` the first step's; ``grad_norm_gap``: the worst leaf's
    gap between the norms of the first gradient; after the third step:
    ``change_norm_gap``, the worst leaf's gap between the norms of the
    parameters' change, ``change_median_gap`` the median leaf's,
    ``change_cos_gap`` the median leaf's one less the cosine between the
    two changes; ``nu_rms_gap``, the worst leaf's gap between the norms of
    the root of Adam's second moment; ``stat_change_gap``, the worst
    running statistic's gap between the norms of its change (each gap of
    norms against the larger of the reference leaf's norm and the median
    leaf's).  ``control`` puts the reference in the program's place:
    ``"control"`` one precision lower (float8 products), ``"half"`` on
    half of each batch, ``"sign"`` stepping up the gradient."""
    b1 = ref.ADAM[0]
    if control is None:
        losses = st.first_losses
        g1 = [m / (1.0 - b1) for m in st.mu1]
        p3, nu3, stats3 = st.p3, st.nu3, st.stats3
    st.engine = st.state = st.train_step = None
    harness.free_device_memory()
    with harness.reference_numerics():
        if control is not None:
            losses, g1, p3, nu3, stats3 = _reference_steps(
                st, quant=ref.fp8_quant if control == "control" else None,
                half=control == "half",
                lr_sign=-1.0 if control == "sign" else 1.0)
        r_losses, r_g1, r_p3, r_nu3, r_stats3 = _reference_steps(st)
    p0 = [st.sd[n] for n in st.names]
    r_g = _norms(r_g1)
    med = float(torch.tensor(r_g).median())
    moving = [g >= ZERO_GRAD * med for g in r_g]
    d_p = [a - b for a, b in zip(p3, p0)]
    d_r = [a - b for a, b in zip(r_p3, p0)]
    chg = _leaf_gaps(_norms(d_p), _norms(d_r), moving)
    cos = [float(torch.nn.functional.cosine_similarity(
        a.double().reshape(1, -1), b.double().reshape(1, -1), eps=1e-30))
        for a, b, keep in zip(d_p, d_r, moving) if keep]
    names = sorted(r_stats3)
    d_s = [stats3[n] - st.sd[n] for n in names]
    r_d_s = [r_stats3[n] - st.sd[n] for n in names]
    loss = [abs(a - r) / abs(r) for a, r in zip(losses, r_losses)]
    return dict(loss_gap=max(loss), loss1_gap=loss[0],
                grad_norm_gap=max(_leaf_gaps(_norms(g1), r_g)),
                change_norm_gap=max(chg),
                change_median_gap=float(torch.tensor(chg).median()),
                change_cos_gap=1.0 - float(torch.tensor(cos).median()),
                nu_rms_gap=max(_leaf_gaps(_norms([v.sqrt() for v in nu3]),
                                          _norms([v.sqrt() for v in r_nu3]))),
                stat_change_gap=max(_leaf_gaps(_norms(d_s), _norms(r_d_s))))
