"""A dry run of the port over N ranks, counterpart of the JAX package's
``__graft_entry__.py::_dryrun_impl``:

    python -m deepi2p_tpu_torch.parallel.dryrun --ranks 4 [--device cuda]

spawns N ranks (gloo on the CPU; on cards NCCL when every rank has a card
of its own, else gloo with the ranks sharing them) and checks, against the
single-process computation in the launching process:

* the DP/TP train step of the tiny config on a batch of ``2 * n_data``
  (``n_model = 2`` when N >= 4 and even): the loss and metrics, those of
  the eval step from the same initial state, the gradient of a float64 copy (gathered over the model axis), parameters
  bitwise equal across ranks after the step, the running statistics;
* with ``n_model > 1``, the JAX dry run's point-axis sharding
  (``__graft_entry__.py:120-146``): after the step, the batch placed with
  the clouds' point axis split over the model ranks as well
  (``mesh.shard_points``; the engine gathers it at the step's entry, as
  GSPMD inserts all-gathers), its eval loss within 1e-3 relative of the
  DP layout's, then a train step from it to a finite loss with the
  parameters bitwise equal across ranks;
* the sharded registration, 2-D and 6-DoF, of a batch of ``2 * N`` pairs
  over all N ranks, held to the one-rank solve with the same pair
  generators at the JAX dry run's tolerances.

:func:`launch` and :func:`rank_job` are the building blocks the tests and
``chip_smoke.py`` use: a job is a dict, each rank writes its results to
``<out>/rank<r>.pt``.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config as config_mod
from ..data.synthetic import synthetic_batch
from ..models.detector import INPUT_KEYS
from ..train.engine import Engine, TrainState
from .mesh import (Mesh, ShardedEngine, gather_state, make_mesh, n_split,
                   shard_points)
from .registration import (make_sharded_registration, pair_generators,
                           place_for_registration)

# the JAX dry run's bounds (__graft_entry__.py:188-214)
POSE_2D = dict(rtol=1e-4, atol=1e-5)
POSE_6D = dict(rtol=1e-3, atol=2e-4)
COST = dict(rtol=1e-4, atol=1e-3)
GRAD64_ATOL = 1e-8
POINTS_RTOL = 1e-3   # the point-sharded eval loss (__graft_entry__.py:136)
SEED, GEN_SEED, PAIR_SEED = 0, 1, 7   # weights, dropout, pair inits


def make_config(preset: str = "tiny", **overrides) -> config_mod.Config:
    return getattr(config_mod, preset)(**overrides)


def part_config(part: Dict) -> config_mod.Config:
    """A job part's configuration: its ``preset`` (default ``tiny``) with
    its ``cfg`` overrides."""
    return make_config(part.get("preset", "tiny"), **part.get("cfg", {}))


# --------------------------------------------------------------------------
# one rank
# --------------------------------------------------------------------------

def _load_weights(state: TrainState, weights: Optional[str]) -> None:
    if weights:
        state.model.load_state_dict(torch.load(weights, weights_only=True))


def _no_dropout(model) -> None:
    for layer in model.per_point_pn.layers:
        layer.dropout_rate = 0.0


def full_grads(mesh: Mesh, state: TrainState, grads
               ) -> Dict[str, torch.Tensor]:
    """The gradient by parameter name, split leaves gathered over the model
    axis (the shapes of a single-process model)."""
    from .collectives import gather_cat
    split = {id(p): layer.tp for layer in state.model.modules()
             if getattr(layer, "tp", None) is not None
             for p in (layer.conv.weight, layer.conv.bias)}
    out = {}
    for (name, p), g in zip(state.model.named_parameters(), grads):
        tp = split.get(id(p))
        out[name] = (g if tp is None else
                     gather_cat(g.contiguous(), tp.group, tp.index, tp.size,
                                dim=0)).detach().cpu()
    return out


def digest(tensors: Dict[str, torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes, in key order: equal digests are
    bitwise equal tensors."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _job_state(eng: Engine, job: Dict) -> TrainState:
    """The job's single-process initial state (seeded or loaded weights,
    dropout off if asked)."""
    state = Engine.init_state(eng, SEED)
    _load_weights(state, job.get("weights"))
    if not job.get("dropout", True):
        _no_dropout(state.model)
    return state


def train_job(mesh: Mesh, cfg, job: Dict) -> Dict:
    """A sharded train step, the eval step before it, and a float64 copy's
    gradient, on this rank.  Rank 0 also takes the single-process steps
    (:func:`reference_step`) and records how far the sharded ones are from
    them; every rank records digests of its gathered gradient and
    parameters, which must agree across ranks."""
    batch = dict(np.load(job["batch"]))
    ref = reference_step(cfg, job, mesh.device) if mesh.rank == 0 else None
    out: Dict = {}
    eng = ShardedEngine(cfg.replace(compute_dtype="float64"), mesh,
                        steps_per_epoch=10)
    state = eng.shard_state(_job_state(eng, job))
    state.model.double()
    loss, _, grads = eng.loss_and_grads(
        state, eng.place_batch(batch), torch.Generator().manual_seed(GEN_SEED))
    full = full_grads(mesh, state, grads)
    out["loss64"] = float(loss)
    out["grads64_sha"] = digest(full)
    if ref is not None:
        out["grad64_err"] = max_abs(full, ref["grads64"])
        out["stats64_err"] = _stats_err(_stats(state.model), ref["stats64"])
    eng = ShardedEngine(cfg, mesh, steps_per_epoch=10)
    state = eng.shard_state(_job_state(eng, job))
    out["n_split"] = n_split(state)
    local = eng.place_batch(batch)
    out["eval"] = _floats(eng.eval_step(state, local))
    gen = torch.Generator().manual_seed(GEN_SEED)
    times = []
    for i in range(job.get("steps", 1)):
        _sync(mesh)
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, local, gen)
        _sync(mesh)
        times.append(time.perf_counter() - t0)
        if i == 0:   # the step the single-process one is held to
            out["metrics"] = _floats(metrics)
            out["stats"] = _stats(state.model)
    out["step_s"] = times
    out["params_sha"] = digest(gather_state(mesh, state).model.state_dict())
    if mesh.n_model > 1:
        out["points"] = points_step(mesh, eng, state, batch, local, gen)
    if ref is not None:
        out["ref"] = {k: ref[k] for k in ("metrics", "eval", "stats",
                                          "loss64", "step_s")}
    return out


def points_step(mesh: Mesh, eng: ShardedEngine, state: TrainState,
                batch: Dict, local: Dict, gen: torch.Generator) -> Dict:
    """The JAX dry run's point-axis sharding: the eval loss of the batch
    with the clouds' point axis split over the model ranks against that
    of ``local`` (the DP layout), then a train step from the point-sharded
    batch."""
    sp = shard_points(mesh, batch)
    loss_dp = float(eng.eval_step(state, local)["loss"])
    loss_sp = float(eng.eval_step(state, sp)["loss"])
    state, metrics = eng.train_step(state, sp, gen)
    return dict(points=tuple(sp["pc"].shape), eval_loss_dp=loss_dp,
                eval_loss=loss_sp, loss=float(metrics["loss"]),
                params_sha=digest(gather_state(mesh, state).model
                                  .state_dict()))


def register_job(mesh: Mesh, cfg, job: Dict) -> Dict:
    """The sharded registration of a batch on this rank, in each mode."""
    from ..ops.knn_cuda import knn_cuda
    from ..register.frustum_cuda import lm_solve_cuda
    batch = dict(np.load(job["batch"]))
    model = build_detector_for(cfg, mesh.device, SEED, job.get("weights"))
    gens = pair_generators(PAIR_SEED, batch["pc"].shape[0])
    model, local, my_gens = place_for_registration(mesh, model, batch, gens)

    chunk = job.get("forward_chunk")

    def apply_fn(b):
        """The coarse logits, the forward taken ``chunk`` pairs at a time
        (the same launch shapes on one rank as on several)."""
        n = b["pc"].shape[0]
        step = chunk or n
        outs = []
        for lo in range(0, n, step):
            out = model.eval()(*(b[k][lo:lo + step] for k in INPUT_KEYS))
            outs.append(out[0] if cfg.is_fine_resolution else out)
        return torch.cat(outs)

    out: Dict = {}
    for mode in ("2d", "6dof"):
        step = make_sharded_registration(
            mesh, apply_fn, H=cfg.img_H, W=cfg.img_W,
            n_inits=job.get("n_inits", 8), max_iter=job.get("max_iter", 4),
            solver_stride=job.get("solver_stride", 1), is_2d=mode == "2d")
        gens_now = [torch.Generator().set_state(g.get_state())
                    for g in my_gens]
        knn0, lm0 = knn_cuda.launches, (lm_solve_cuda.launches
                                        + lm_solve_cuda.launches_p6)
        # one rank may solve in chunks of another layout's shard, so that
        # every launch has a rank's shape (the LM kernel's plan, and with
        # it its sum order, follows the launch's pairs)
        per = (job.get("solve_chunk") if mesh.n_data == 1 else None) \
            or len(gens_now)
        _sync(mesh)
        t0 = time.perf_counter()
        parts = [step({k: v[lo:lo + per] for k, v in local.items()},
                      gens_now[lo:lo + per], with_inits=True)
                 for lo in range(0, len(gens_now), per)]
        P, cost, theta0 = (torch.cat(x) for x in zip(*parts))
        _sync(mesh)
        out[mode] = dict(P=P.cpu(), cost=cost.cpu(), theta0=theta0.cpu(),
                         s=time.perf_counter() - t0,
                         knn_launches=knn_cuda.launches - knn0,
                         lm_launches=(lm_solve_cuda.launches
                                      + lm_solve_cuda.launches_p6 - lm0))
    return out


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _stats(model) -> Dict[str, torch.Tensor]:
    """A copy of the batch-norm running statistics by name, on the CPU
    (later steps update the model's in place)."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def build_detector_for(cfg, device="cpu", seed: int = 0,
                       weights: Optional[str] = None):
    """The eval-mode detector of a registration job: seeded weights, or a
    saved state dict."""
    from ..models.detector import build_detector
    model = build_detector(cfg, device=device, seed=seed)
    if weights:
        model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def rank_job(rank: int, world: int, init: str, backend: str, device: str,
             job: Dict, out_dir: str) -> None:
    """The body of one spawned rank: join the process group, run the
    job's parts, write ``<out_dir>/rank<rank>.pt``."""
    torch.set_num_threads(1)     # the ranks share the host's cores
    # the checks compare f32 steps: no TF32 in cuDNN convolutions (on by
    # default) or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        result: Dict = {"device": str(dev), "backend": backend}
        for key in ("train", "train_tp", "register", "register_main"):
            if key not in job:
                continue
            part = job[key]
            mesh = make_mesh(part.get("n_model", 1), device=dev)
            run_part = (register_job if key.startswith("register")
                        else train_job)
            result[key] = run_part(mesh, part_config(part), part)
            result[key]["mesh"] = mesh.shape
            if key == "train":
                result["mesh"] = mesh.shape
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(world: int, job: Dict, out_dir: str, device: str = "cpu",
          backend: Optional[str] = None):
    """Spawn ``world`` ranks on ``job`` and return at once; :func:`wait`
    collects them."""
    import torch.multiprocessing as mp
    if backend is None:
        backend = ("nccl" if device == "cuda"
                   and world <= torch.cuda.device_count() else "gloo")
    init = "file://" + os.path.join(out_dir, "pg_init")
    ctx = mp.start_processes(rank_job, args=(world, init, backend, device,
                                             job, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, out_dir


def wait(handle, timeout_s: float = 600.0) -> List[Dict]:
    """The ranks' results in rank order.  A rank that fails fails the
    launch (no rank carries on alone); one that hangs is killed at the
    time limit."""
    ctx, world, out_dir = handle
    deadline = time.time() + timeout_s
    while not ctx.join(timeout=max(deadline - time.time(), 1.0)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in "
                               f"{timeout_s:.0f} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def launch(world: int, job: Dict, out_dir: str, device: str = "cpu",
           backend: Optional[str] = None, timeout_s: float = 600.0
           ) -> List[Dict]:
    """:func:`start` then :func:`wait`."""
    return wait(start(world, job, out_dir, device, backend), timeout_s)


# --------------------------------------------------------------------------
# the single-process references
# --------------------------------------------------------------------------

def reference_step(cfg, job: Dict, device="cpu") -> Dict:
    """The single-process counterpart of :func:`train_job`: the float64
    copy's gradient and statistics, the f32 eval step's metrics, and the
    f32 step's metrics and statistics."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in np.load(job["batch"]).items()}
    out: Dict = {}
    eng = Engine(cfg.replace(compute_dtype="float64"), 10, device=device)
    state = _job_state(eng, job)
    state.model.double()
    loss, _, grads = eng.loss_and_grads(
        state, batch, torch.Generator().manual_seed(GEN_SEED))
    out["loss64"] = float(loss)
    out["grads64"] = {n: g.detach().cpu() for (n, _), g in
                      zip(state.model.named_parameters(), grads)}
    out["stats64"] = _stats(state.model)
    del state, grads
    eng = Engine(cfg, 10, device=device)
    state = _job_state(eng, job)
    out["eval"] = _floats(eng.eval_step(state, batch))
    gen = torch.Generator().manual_seed(GEN_SEED)
    cuda = torch.device(device).type == "cuda"
    times = []
    for i in range(job.get("steps", 1)):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = eng.train_step(state, batch, gen)
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        if i == 0:
            out["metrics"] = _floats(metrics)
            out["stats"] = _stats(state.model)
    out["step_s"] = min(times)
    return out


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def max_abs(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    assert a.keys() == b.keys()
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


def _stats_err(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
               ) -> float:
    """The largest difference of two sets of running statistics, relative
    to the statistic and at least 1."""
    return max(float(((a[k].double() - b[k].double()).abs()
                      / b[k].double().abs().clamp(min=1.0)).max())
               for k in b)


RATIO_METRICS = ("coarse_accuracy", "fine_accuracy", "inside_precision",
                 "inside_recall")


def check_train(results: List[Dict], loss_rtol: float = 1e-5,
                stats_rtol: Optional[float] = 1e-5,
                stats64_rtol: float = 1e-6,
                ratio_atol: Optional[float] = None, key: str = "train"
                ) -> Dict:
    """Hold the ranks' train results to the single-process step rank 0
    took; returns the readings.  Raises AssertionError on a violation.

    The train step's and the eval step's (eval-mode forward of the
    initial state) losses within ``loss_rtol``; the accuracies, precision and recall
    (ratios of counts, where one point whose argmax rounding flips moves
    the value by one over the count) within ``ratio_atol`` if given, else
    as the losses.  The f32 running statistics within ``stats_rtol``
    (None: read, not held): the later layers' inputs carry the rounding
    of every layer before them (up to 9e-6 relative between one rank and
    two at the tiny config), and a channel whose mean is large against
    its spread loses most of its variance's digits to ``E[x^2] - mean^2``
    in f32 (9% between one rank and two in one channel of the KITTI-shaped
    config on the CPU); the float64 copy's, after its forward, within
    ``stats64_rtol``."""
    tr = [r[key] for r in results]
    ref = tr[0]["ref"]
    read = {"n_split": tr[0]["n_split"]}
    assert len({t["grads64_sha"] for t in tr}) == 1, "rank gradients"
    read["grad64_err"] = tr[0]["grad64_err"]
    assert read["grad64_err"] <= GRAD64_ATOL, read
    read["stats64_err"] = tr[0]["stats64_err"]
    assert read["stats64_err"] <= stats64_rtol, read
    for part in ("metrics", "eval"):
        for k, v in ref[part].items():
            tol = (ratio_atol if ratio_atol is not None
                   and k in RATIO_METRICS else loss_rtol * max(abs(v), 1.0))
            for t in tr:
                got = t[part][k]
                assert abs(got - v) <= tol, (part, k, got, v)
    read["loss"] = tr[0]["metrics"]["loss"]
    read["loss_ref"] = ref["metrics"]["loss"]
    read["eval_loss"] = tr[0]["eval"]["loss"]
    assert len({t["params_sha"] for t in tr}) == 1, "rank parameters"
    read["stats_err"] = _stats_err(tr[0]["stats"], ref["stats"])
    assert stats_rtol is None or read["stats_err"] <= stats_rtol, read
    read["step_s"] = min(tr[0]["step_s"])
    read["step_s_ref"] = ref["step_s"]
    if "points" in tr[0]:
        read["points"] = check_points([t["points"] for t in tr])
    return read


def check_points(pts: List[Dict]) -> Dict:
    """The ranks' point-sharded readings (:func:`points_step`): each eval
    loss within :data:`POINTS_RTOL` of its DP layout's, a finite train
    loss, parameters bitwise equal across ranks.  Returns rank 0's
    readings with the largest relative difference of the eval losses."""
    diff = 0.0
    for p in pts:
        ref = p["eval_loss_dp"]
        d = abs(p["eval_loss"] - ref) / max(abs(ref), 1.0)
        assert d <= POINTS_RTOL, ("point-sharded eval loss", p)
        assert math.isfinite(p["loss"]), ("point-sharded train loss", p)
        diff = max(diff, d)
    assert len({p["params_sha"] for p in pts}) == 1, \
        "rank parameters after the point-sharded step"
    return dict(pts[0], eval_rel_diff=diff)


def check_register(results: List[Dict], ref: Dict, key: str = "register"
                   ) -> Dict:
    """The ranks' registration against the one-rank solve ``ref``: inits
    bitwise, poses and costs at the JAX dry run's bounds.  Returns rank
    0's times and bitwise poses, and every rank's launches."""
    read = {}
    for mode, pose in (("2d", POSE_2D), ("6dof", POSE_6D)):
        if mode not in ref:
            continue
        for r in results:
            got = r[key][mode]
            assert torch.equal(got["theta0"], ref[mode]["theta0"]), mode
            np.testing.assert_allclose(got["P"].numpy(),
                                       ref[mode]["P"].numpy(), **pose)
            np.testing.assert_allclose(got["cost"].numpy(),
                                       ref[mode]["cost"].numpy(), **COST)
        got = results[0][key][mode]
        read[mode] = dict(
            s=got["s"], s_ref=ref[mode]["s"],
            bitwise=int((got["P"] == ref[mode]["P"]).all(-1).all(-1).sum()),
            finite=bool(torch.isfinite(got["P"]).all()
                        and torch.isfinite(got["cost"]).all()),
            knn_launches=[r[key][mode]["knn_launches"] for r in results],
            lm_launches=[r[key][mode]["lm_launches"] for r in results])
    return read


def run(ranks: int, device: str = "cpu") -> Dict:
    """The dry run (module docstring); returns its readings."""
    n_model = 2 if ranks >= 4 and ranks % 2 == 0 else 1
    cfg = make_config("tiny")
    n_data = ranks // n_model
    with tempfile.TemporaryDirectory() as tmp:
        train_batch = os.path.join(tmp, "train.npz")
        np.savez(train_batch, **synthetic_batch(cfg, 2 * n_data, seed=0))
        reg_batch = os.path.join(tmp, "reg.npz")
        np.savez(reg_batch, **synthetic_batch(cfg, 2 * ranks, seed=2))
        # the one rank forwards and solves in a rank's chunks: the
        # convolutions' algorithms and the LM's plan follow the launch's
        # pairs, and with them the rounding
        job = {"train": {"n_model": n_model, "batch": train_batch},
               "register": {"batch": reg_batch, "forward_chunk": 2,
                            "solve_chunk": 2}}
        results = launch(ranks, job, tmp, device=device)
        read = {"mesh": results[0]["mesh"],
                "backend": results[0]["backend"],
                "train": check_train(results)}
        if n_model > 1:
            assert read["train"]["n_split"] > 0, read
        read["register"] = check_register(results, register_job(
            make_mesh(1, device=device), cfg, job["register"]))
    return read


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = p.parse_args(argv)
    read = run(args.ranks, args.device)
    print(f"dryrun ok: mesh={read['mesh']} backend={read['backend']} "
          f"split={read['train']['n_split']} "
          f"grad64_err={read['train'].get('grad64_err')} "
          f"loss={read['train']['loss']} ref={read['train']['loss_ref']} "
          f"eval_loss={read['train']['eval_loss']}"
          + ("" if "points" not in read["train"] else
             f" points={read['train']['points']['points']} "
             f"points_eval_loss={read['train']['points']['eval_loss']} "
             f"(dp {read['train']['points']['eval_loss_dp']}) "
             f"points_loss={read['train']['points']['loss']}"),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
