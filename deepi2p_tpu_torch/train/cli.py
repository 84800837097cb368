"""Training entry point of the port, the JAX package's ``train.cli`` on
one card:

    python -m deepi2p_tpu_torch.train.cli --dataset kitti \\
        --dataroot /data/kitti --checkpoints-dir runs/ck --log-dir runs/log \\
        [--workers 8] [--epochs E] [--resume] [--warm-start FILE.npz] \\
        [--device cpu]
    python -m deepi2p_tpu_torch.train.cli --dataset synthetic \\
        --synthetic-preset kitti --synthetic-scene street --points 8192 \\
        --nodes 128 ...

The flags are the JAX CLI's plus ``--device`` (default: the card).  A
real dataset (``oxford``, ``kitti``, ``nuscenes``) trains at its preset
(``config.<dataset>``) from ``--dataroot``, train split against val split.
The epoch loop is the JAX one (``kitti/train_classifier.py:54-154``):
shuffled batches (seed ``seed + epoch``) from ``--workers`` loader threads,
pinned and copied to the card ahead of the step
(:func:`~..data.loader.device_prefetch`), one
:meth:`~.engine.Engine.train_step` each, scalars every ``--log-every``
steps, validation on the held-out set at each epoch's end,
then a full checkpoint (:class:`~.checkpoint.CheckpointManager`) and
``latest.npz`` (:func:`~.checkpoint.export_npz`, which the JAX package and
either ``eval.cli dump`` read).  ``--resume`` restores the latest
checkpoint and wins over ``--warm-start``; both floor the step to its
epoch's start, so an interrupted epoch runs again from its beginning.

``--steps-per-dispatch K`` takes K train steps per call
(:meth:`~.engine.Engine.train_step_scan`, the JAX ``lax.scan``) on a
stack of K consecutive batches (:func:`stacked`; a ragged tail of fewer
than K is dropped), and rounds the epoch down to a multiple of K before
the schedule, the checkpoints' ``keep_period`` and the resume floor read
it.  ``--ckpt-every`` and ``--log-every`` are checked after each call, so
a save or a log line comes at the first call boundary at or past them,
and the log shows the call's last step.  With steps that K divides, a
run of K-step calls ends at the state of the run of single steps.

``--device-data`` (``--dataset synthetic`` only) makes every batch on the
training device (:func:`~..data.synthetic_device.synthetic_batch_device`):
no loader thread, pinned buffer or host copy.  Train batch ``i`` of epoch
``e`` comes from a generator seeded with :func:`device_seed` of ``(seed +
424242, e, i)``, a fresh scene every step; validation takes the same
``max(len(val) // batch_size, 1)`` batches every epoch, seeded with
``(seed + 31337, i)``.  With K > 1, call ``d`` of an epoch stacks the
batches of steps ``d*K .. d*K+K-1``, each from its own generator.

Several ranks: under ``torch.distributed.run`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` in the environment) each rank joins one process group
(NCCL on cards, gloo with ``--device cpu``; a rank's card is
``cuda:LOCAL_RANK``, which must exist) and trains on a (data, model)
layout of ranks (:mod:`..parallel.mesh`), ``--mesh-model`` of them on the
model axis and ``n_data = gcd(batch, world // mesh_model)`` on the data
axis, the JAX CLI's rule; a rank beyond ``n_data * mesh_model`` takes no
part and exits 0.  With ``--device-data`` every rank makes the single
process's global batch from the same seeds and keeps its slice, so the
losses are the one-rank run's; from a dataset each rank reads its share
of each batch of the global order.  A K-step call's stack keeps K whole
and splits B the same way.  Rank 0 alone writes checkpoints
(the split weights gathered first) and logs.  Without those variables the
world is this one process.

Refused, never ignored: ``--mesh-model M`` with a world size that M does
not divide.
"""
from __future__ import annotations

import argparse
import itertools
import math
import os
import time

import numpy as np
import torch

from .. import config as config_mod
from ..data import BatchLoader, SyntheticDataset, device_prefetch
from ..data.synthetic_device import (synthetic_batch_device,
                                     synthetic_stacked_device)
from ..parallel.mesh import ShardedEngine, make_mesh
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, export_npz, warm_start_npz
from .engine import Engine


def world_size() -> int:
    """The ranks of ``torch.distributed.run`` (``WORLD_SIZE``), or 1."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def refusal(args, world: int = 1) -> str:
    """The message for a flag this port does not support, or ''."""
    if args.dataset != "synthetic" and not args.dataroot:
        return f"--dataset {args.dataset} needs --dataroot"
    if args.mesh_model < 1 or world % args.mesh_model:
        return (f"--mesh-model {args.mesh_model} needs a world size that "
                f"is a multiple of it; the world has {world} rank(s)")
    if args.device_data and args.dataset != "synthetic":
        return "--device-data requires --dataset synthetic"
    return ""


PRESETS = {"oxford": config_mod.oxford, "kitti": config_mod.kitti,
           "nuscenes": config_mod.nuscenes, "tiny": config_mod.tiny}


def build_config(args) -> config_mod.Config:
    maker = PRESETS[args.synthetic_preset if args.dataset == "synthetic"
                    else args.dataset]
    overrides = {"dataroot": args.dataroot,
                 "checkpoints_dir": args.checkpoints_dir}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.coarse_only:
        overrides["is_fine_resolution"] = False
    if args.points:
        overrides["input_pt_num"] = args.points
    if args.nodes:
        overrides["node_a_num"] = args.nodes
        overrides["node_b_num"] = args.nodes
        # kNN over node_b cannot ask for more neighbours than nodes exist
        overrides["k_ab"] = min(maker().k_ab, args.nodes)
    if args.synthetic_scene:
        overrides["synthetic_scene"] = args.synthetic_scene
    if args.img_h:
        overrides["img_H"] = args.img_h
    if args.img_w:
        overrides["img_W"] = args.img_w
    if args.lr_decay_step:
        overrides["lr_decay_step"] = args.lr_decay_step
    if args.inside_weight:
        overrides["coarse_inside_weight"] = args.inside_weight
    return maker(**overrides)


def build_datasets(cfg, args):
    """(train, val) datasets: the real loaders' train and val splits, or
    synthetic sets (val seeded apart, ``--val-len`` or a quarter)."""
    if args.dataset == "synthetic":
        train = SyntheticDataset(cfg, length=args.synthetic_len, seed=0,
                                 fresh=args.fresh_scenes)
        val = SyntheticDataset(
            cfg, length=args.val_len or max(args.synthetic_len // 4, 1),
            seed=1)
        return train, val
    from .. import data
    loader = {"oxford": data.OxfordLoader, "kitti": data.KittiLoader,
              "nuscenes": data.NuScenesLoader}[args.dataset]
    return (loader(args.dataroot, "train", cfg),
            loader(args.dataroot, "val", cfg))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepI2P port trainer")
    p.add_argument("--dataset", default="synthetic",
                   choices=["oxford", "kitti", "nuscenes", "synthetic"])
    p.add_argument("--dataroot", default="")
    p.add_argument("--checkpoints-dir", default="checkpoints")
    p.add_argument("--log-dir", default="runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--coarse-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--workers", type=int, default=8,
                   help="loader threads over the dataset")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--synthetic-len", type=int, default=32)
    p.add_argument("--val-len", type=int, default=None,
                   help="synthetic: validation-set size (default len//4)")
    p.add_argument("--fresh-scenes", action="store_true",
                   help="synthetic: a never-seen scene per (epoch, index) "
                        "instead of re-iterating a finite set")
    p.add_argument("--synthetic-scene", default=None,
                   choices=["uniform", "street"])
    p.add_argument("--synthetic-preset", default="tiny",
                   choices=["tiny", "kitti", "oxford", "nuscenes"],
                   help="config preset for --dataset synthetic")
    p.add_argument("--points", type=int, default=None,
                   help="override cfg.input_pt_num")
    p.add_argument("--nodes", type=int, default=None,
                   help="override node_a_num/node_b_num")
    p.add_argument("--img-h", type=int, default=None)
    p.add_argument("--img-w", type=int, default=None)
    p.add_argument("--lr-decay-step", type=int, default=None)
    p.add_argument("--inside-weight", type=float, default=None,
                   help="up-weight the inside-frustum coarse class in the "
                        "focal loss (cfg.coarse_inside_weight)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="also checkpoint every N steps (0 = per epoch only)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K train steps per call on a stack of K "
                        "consecutive batches (the same steps, in the same "
                        "order, as K single steps); an epoch is rounded "
                        "down to a multiple of K")
    p.add_argument("--device-data", action="store_true",
                   help="synthetic: make every batch on the training device")
    p.add_argument("--warm-start", default="",
                   help="export_npz file to start from when no checkpoint "
                        "is resumed (fresh Adam moments)")
    p.add_argument("--warm-start-partial", action="store_true",
                   help="transfer only shape-matching leaves from "
                        "--warm-start (cross-geometry); resets the step")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def device_seed(*parts: int) -> int:
    """The seed of one device-data generator:
    ``np.random.SeedSequence(parts).generate_state(1)[0]``."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1)[0])


def device_batches(cfg, device, seeds, k: int = 1):
    """One :func:`synthetic_batch_device` batch on ``device`` for each
    tuple of seed parts in ``seeds``; with ``k > 1``, one (k, B, ...)
    stack (:func:`synthetic_stacked_device`) of each k consecutive ones,
    a ragged tail dropped."""
    seeds = iter(seeds)
    while True:
        group = list(itertools.islice(seeds, k))
        if len(group) < k:
            return
        gens = [torch.Generator(device=device).manual_seed(device_seed(*p))
                for p in group]
        yield (synthetic_batch_device(cfg, gens[0]) if k == 1
               else synthetic_stacked_device(cfg, gens))


def stacked(batches, k: int):
    """Group ``k`` consecutive host batches (dicts of (B, ...) arrays)
    into one dict of (k, B, ...) arrays; a ragged tail of fewer than ``k``
    is dropped.  Closing this generator closes ``batches``."""
    it = iter(batches)
    try:
        while True:
            group = list(itertools.islice(it, k))
            if len(group) < k:
                return
            yield {key: np.stack([g[key] for g in group])
                   for key in group[0]}
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def rank_device(device: str) -> torch.device:
    """A rank's device: ``cuda`` is this rank's card, ``cuda:LOCAL_RANK``,
    which must exist; any other name is taken as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or "LOCAL_RANK" not in os.environ:
        return dev
    local = int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(f"LOCAL_RANK {local} has no card: this host has "
                           f"{n} (NCCL takes one rank per card)")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.warm_start_partial and not args.warm_start:
        p.error("--warm-start-partial requires --warm-start")
    world = world_size()
    msg = refusal(args, world)
    if msg:
        raise SystemExit(msg)

    cfg = build_config(args)
    distributed = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    device = rank_device(args.device)
    if distributed:
        import torch.distributed as dist
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    try:
        return _train(args, cfg, device, world, distributed)
    finally:
        if distributed:
            dist.destroy_process_group()


def _train(args, cfg, device, world: int, distributed: bool):
    # the data axis must divide the batch; ranks beyond it take no part
    n_data = (math.gcd(cfg.batch_size, world // args.mesh_model)
              if distributed else 1)
    mesh = (make_mesh(args.mesh_model, n_data, device=device)
            if distributed else make_mesh(device=device))
    lead = mesh.rank == 0
    if not mesh.member:
        print(f"rank {mesh.rank} takes no part: the mesh {mesh.shape} uses "
              f"{n_data * args.mesh_model} of {world} ranks", flush=True)
        return None
    if lead and distributed:
        print(f"mesh {mesh.shape} over {world} ranks", flush=True)

    def say(*a, **kw):
        if lead:
            print(*a, **kw)
    epochs = args.epochs if args.epochs is not None else cfg.epochs
    train_ds, val_ds = build_datasets(cfg, args)
    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
    K = max(args.steps_per_dispatch, 1)
    if steps_per_epoch < K:
        raise SystemExit(f"--steps-per-dispatch {K} exceeds the epoch's "
                         f"{steps_per_epoch} steps")
    if steps_per_epoch % K:
        # the ragged tail of < K batches is dropped: the schedule's epoch,
        # keep_period and the resume floor follow the steps that run
        dropped = steps_per_epoch % K
        steps_per_epoch -= dropped
        say(f"steps-per-dispatch {K}: epoch rounded to {steps_per_epoch} "
            f"steps ({dropped} ragged batches/epoch dropped)")

    engine = ShardedEngine(cfg, mesh, steps_per_epoch=steps_per_epoch)
    logger = MetricsLogger(args.log_dir) if lead else None
    # keep_period: mid-epoch --ckpt-every saves must not evict the epoch
    # boundaries (max_to_keep=5 alone cycles in 5 saves)
    ckpt = CheckpointManager(cfg.checkpoints_dir,
                             keep_period=10 * steps_per_epoch)
    npz_path = os.path.join(cfg.checkpoints_dir, "latest.npz")
    # the single-process state: a restore or warm start fills it, then it
    # is laid out on the mesh
    state = Engine.init_state(engine, seed=args.seed)
    start_epoch = 0

    def save(state, metrics=None):
        """Rank 0 writes the single-process form of the state."""
        full = engine.gather_state(state) if mesh.n_model > 1 else state
        if lead:
            ckpt.save(full, metrics=metrics)
            export_npz(full, npz_path)

    def floor_to_epoch(what):
        """Restart an interrupted epoch from its beginning: floor the step
        to the epoch boundary, so the schedule's ``step //
        steps_per_epoch`` and the ``--epochs`` budget stay aligned with the
        loop's epoch across kill and resume."""
        step0 = state.step
        epoch = step0 // steps_per_epoch
        state.step = epoch * steps_per_epoch
        say(f"{what} at step {step0} (epoch {epoch}"
              + (f"; step floored to {state.step}"
                 if state.step != step0 else "") + ")")
        return epoch

    resumable = args.resume and ckpt.latest_step() is not None
    if args.warm_start and resumable:
        say(f"warm-start SKIPPED: --resume found a checkpoint at step "
              f"{ckpt.latest_step()} in {cfg.checkpoints_dir}, which wins "
              f"over --warm-start {args.warm_start}")
    elif args.warm_start:
        warm_start_npz(state, args.warm_start,
                       partial=args.warm_start_partial)
        start_epoch = floor_to_epoch(f"warm-started from {args.warm_start}")
    if resumable:
        ckpt.restore(state)
        # --epochs is the total budget: fresh-scene seeds, the validation
        # cadence and the log pick up where the interrupted run stopped
        start_epoch = floor_to_epoch("resumed")
    engine.shard_state(state)

    generator = torch.Generator(device=engine.device).manual_seed(
        args.seed + 1)
    shard = (mesh.data_index, mesh.n_data)
    last_ckpt = last_log = state.step
    for epoch in range(start_epoch, epochs):
        t_epoch = time.time()
        if hasattr(train_ds, "set_epoch"):
            train_ds.set_epoch(epoch)
        if args.device_data:
            seeds = ((args.seed + 424242, epoch, i)
                     for i in range(steps_per_epoch))
            stream = (map(engine.place_batch,
                          device_batches(cfg, engine.device, seeds))
                      if K == 1 else map(engine.place_stacked, device_batches(
                          cfg, engine.device, seeds, K)))
        else:
            loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                                 num_workers=args.workers,
                                 seed=args.seed + epoch, shard=shard)
            # a rank's loader reads its share: its stacks are not split
            stream = device_prefetch(loader if K == 1 else stacked(loader, K),
                                     engine.device)
        for batch in stream:
            if K == 1:
                state, metrics = engine.train_step(state, batch, generator)
            else:
                state, metrics = engine.train_step_scan(state, batch,
                                                        generator)
            step = state.step
            if args.ckpt_every and step - last_ckpt >= args.ckpt_every:
                last_ckpt = step
                save(state)
            if step - last_log >= args.log_every:
                last_log = step
                m = {k: float(v) for k, v in metrics.items()}
                if lead:
                    logger.log_scalars("train", m, step)
                say(f"epoch {epoch} step {step}: " +
                    ", ".join(f"{k}={v:.4f}" for k, v in m.items()),
                    flush=True)

        # per-epoch validation (kitti/train_classifier.py:101-137)
        agg, n = {}, 0
        if args.device_data:
            # the same validation scenes every epoch
            val_stream = map(engine.place_batch, device_batches(
                cfg, engine.device, ((args.seed + 31337, i) for i in range(
                    max(len(val_ds) // cfg.batch_size, 1)))))
        else:
            val_stream = device_prefetch(
                BatchLoader(val_ds, cfg.batch_size, shuffle=False,
                            num_workers=args.workers, shard=shard),
                engine.device)
        for batch in val_stream:
            for k, v in engine.eval_step(state, batch).items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        val = {k: v / n for k, v in agg.items()} if n else None
        if val and lead:
            logger.log_scalars("val", val, state.step)
        if val:
            say(f"epoch {epoch} VAL: " +
                ", ".join(f"{k}={v:.4f}" for k, v in val.items()),
                flush=True)
        save(state, metrics=val)
        say(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s",
            flush=True)

    if lead:
        logger.close()
    return state


if __name__ == "__main__":
    main()
