"""Evaluation entry point of the port, the JAX package's ``eval.cli``:

    # 1. dump predictions from an export_npz checkpoint
    python -m deepi2p_tpu_torch.eval.cli dump --dataset synthetic \\
        --synthetic-preset kitti --synthetic-scene street \\
        --checkpoint ckpts/kitti_shape_r4/latest.npz --out runs/dump \\
        [--save-images] [--classify-n 8192 --classify-repeats 2] \\
        [--device cpu]

    # 1b. (ICP) estimated-depth pseudo clouds from the saved images
    python -m deepi2p_tpu_torch.eval.cli depth-dump --data-dir runs/dump \\
        --depth-checkpoint DEPTH_CKPT/depth.npz --out runs/pseudo \\
        [--stride 4] [--device cpu]

    # 2. solve + report RTE/RRE/success
    python -m deepi2p_tpu_torch.eval.cli solve --data-dir runs/dump \\
        --method frustum|pnp|icp|random --img-h 160 --img-w 512 \\
        [--pseudo-dir runs/pseudo] [--debug-vis DIR [--debug-vis-max 4]] \\
        [--device cpu]

``dump`` writes the reference's npy contract (the same files as the JAX
package's ``dump`` for the same dataset and weights) and prints the coarse
and fine accuracy as JSON; ``solve`` runs a registration method over a
dump directory (written by either package) and prints the summary.  The
flags are the JAX package's plus ``--device``, whose default is the card,
and ``--workers``.  ``dump --dataset oxford|kitti|nuscenes --dataroot DIR``
reads the validation split at the dataset's preset in the JAX modes:
Oxford ``val_random_Ry``; KITTI and nuScenes ``val`` with the mode then
set to ``val_random_Ry``.  The loader draws every sample from one
generator, so ``--workers 1`` (the default) gives the same dump on every
run; more threads are faster, and interleave the draws (the JAX dump
reads with 4).  Only ``.npz`` checkpoints are read: orbax directories are
JAX's, and the port's trainer (``train.cli``) writes ``latest.npz``
beside its own checkpoints at every epoch.  ``depth-dump`` (the
reference's ``save_depth_map.py`` stage) runs a DepthNet written by the
port's ``train.depth_cli`` (``depth.npz``) over every ``{prefix}_img.npy``
of a dump written with ``--save-images`` and writes ``{prefix}_pc.npy``,
the clouds ``solve --method icp --pseudo-dir`` registers against.
``solve --debug-vis DIR`` also writes, for the first ``--debug-vis-max``
samples, the solver's trace, TP/FP/FN scene and iteration overlay as PNGs
(``eval/debug_vis.py``) and prints one ``{"debug_vis": ...}`` line for each
before the summary.
"""
from __future__ import annotations

import argparse
import json
import os


def _dump_args(d):
    d.add_argument("--dataset", default="synthetic",
                   choices=["oxford", "kitti", "nuscenes", "synthetic"])
    d.add_argument("--dataroot", default="")
    d.add_argument("--checkpoint", default="",
                   help="export_npz file (empty: seeded weights)")
    d.add_argument("--out", required=True)
    d.add_argument("--batch-size", type=int, default=None)
    d.add_argument("--max-batches", type=int, default=None)
    d.add_argument("--points", type=int, default=None)
    d.add_argument("--nodes", type=int, default=None)
    d.add_argument("--img-h", type=int, default=None)
    d.add_argument("--img-w", type=int, default=None)
    d.add_argument("--synthetic-scene", default=None,
                   choices=["uniform", "street"])
    d.add_argument("--synthetic-preset", default="tiny",
                   choices=["tiny", "kitti", "oxford", "nuscenes"],
                   help="config preset for --dataset synthetic (must match "
                        "the training preset)")
    d.add_argument("--dump-len", type=int, default=16,
                   help="synthetic dump set size")
    d.add_argument("--save-images", action="store_true",
                   help="also save {prefix}_img.npy")
    d.add_argument("--save-probs", action="store_true",
                   help="also save {prefix}_p.npy inside probabilities")
    d.add_argument("--inside-threshold", type=float, default=None,
                   help="coarse decision p_inside > t instead of argmax")
    d.add_argument("--classify-n", type=int, default=0,
                   help="classify at this trained point count on shuffled "
                        "subsets and average per-point probabilities "
                        "(eval.dump.SubsampleEnsemble); 0 = off")
    d.add_argument("--classify-repeats", type=int, default=1,
                   help="average over this many independent covers")
    d.add_argument("--workers", type=int, default=1,
                   help="loader threads (1: the same samples every run)")
    d.add_argument("--device", default="cuda",
                   help="torch device of the detector (default: the card)")


def _solve_args(s):
    s.add_argument("--data-dir", required=True)
    s.add_argument("--method", default="frustum",
                   choices=["frustum", "pnp", "icp", "random"])
    s.add_argument("--img-h", type=int, required=True)
    s.add_argument("--img-w", type=int, required=True)
    s.add_argument("--stride", type=int, default=1)
    s.add_argument("--n-inits", type=int, default=60)
    s.add_argument("--max-iter", type=int, default=64)
    s.add_argument("--use-labels", action="store_true",
                   help="solve from GT labels (oracle mode)")
    s.add_argument("--pseudo-dir", default=None)
    s.add_argument("--save-dir", default=None)
    s.add_argument("--outside-weight", type=float, default=1.0,
                   help="frustum cost: weight on outside-labelled blocks "
                        "(1.0 = reference cost)")
    s.add_argument("--inside-threshold", type=float, default=None,
                   help="re-derive coarse_pred as p_inside > t from dumps "
                        "written with probabilities")
    s.add_argument("--enu2cam", action="store_true",
                   help="convert ENU dumps (nuScenes) to camera convention "
                        "before solving (registration_lsq.py:237-248)")
    s.add_argument("--icp-coarse-threshold", type=float, default=None,
                   help="icp: multi-scale anneal start in metres (None = "
                        "the reference's fixed 1 m)")
    s.add_argument("--icp-seed", default="none", choices=["none", "frustum"],
                   help="icp: seed half the inits around the frustum "
                        "solution from the same predictions")
    s.add_argument("--debug-vis", default=None, metavar="DIR",
                   help="write per-sample solver debug images (trace, "
                        "TP/FP/FN scene, iteration overlay) to DIR")
    s.add_argument("--debug-vis-max", type=int, default=4)
    s.add_argument("--device", default="cuda",
                   help="torch device of the solvers (default: the card; "
                        "'cpu' runs the kernels' plain versions)")


def _depth_dump_args(dd):
    dd.add_argument("--data-dir", required=True,
                    help="dump dir holding {prefix}_img.npy + _K.npy")
    dd.add_argument("--depth-checkpoint", required=True,
                    help="depth.npz (or the directory holding it)")
    dd.add_argument("--out", required=True)
    dd.add_argument("--stride", type=int, default=4)
    dd.add_argument("--device", default="cuda",
                    help="torch device of the depth net (default: the "
                         "card)")


def depth_dump(args):
    import numpy as np

    from .. import config as config_mod
    from ..train.depth_cli import load_depth_fn
    from .depth import dump_pseudo_pointclouds
    from .dump import list_dump_prefixes

    depth_fn = load_depth_fn(args.depth_checkpoint, config_mod.tiny(),
                             device=args.device)
    n = 0
    for prefix in list_dump_prefixes(args.data_dir):
        img_path = os.path.join(args.data_dir, prefix + "_img.npy")
        if not os.path.isfile(img_path):
            continue
        K = np.load(os.path.join(args.data_dir, prefix + "_K.npy"))
        n += dump_pseudo_pointclouds([(prefix, np.load(img_path))], K,
                                     depth_fn, args.out, stride=args.stride,
                                     device=args.device)
    out = {"pseudo_clouds": n, "out": args.out}
    print(json.dumps(out))
    return n


def dump(args):
    from .. import config as config_mod
    from .. import data
    from ..train.checkpoint import load_detector_npz
    from ..train.engine import Engine
    from .dump import SubsampleEnsemble, dump_predictions

    if args.dataset != "synthetic" and not args.dataroot:
        raise SystemExit(f"--dataset {args.dataset} needs --dataroot")
    if args.checkpoint and not args.checkpoint.endswith(".npz"):
        raise SystemExit(f"--checkpoint {args.checkpoint}: only export_npz "
                         ".npz files are read (orbax directories are the JAX "
                         "package's; the port's train.cli writes latest.npz "
                         "in its --checkpoints-dir)")
    maker = {"tiny": config_mod.tiny, "kitti": config_mod.kitti,
             "oxford": config_mod.oxford, "nuscenes": config_mod.nuscenes}[
        args.synthetic_preset if args.dataset == "synthetic"
        else args.dataset]
    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.points:
        overrides["input_pt_num"] = args.points
    if args.nodes:
        overrides["node_a_num"] = args.nodes
        overrides["node_b_num"] = args.nodes
        overrides["k_ab"] = min(maker().k_ab, args.nodes)
    if args.img_h:
        overrides["img_H"] = args.img_h
    if args.img_w:
        overrides["img_W"] = args.img_w
    if args.synthetic_scene:
        overrides["synthetic_scene"] = args.synthetic_scene
    cfg = maker(**overrides)
    if args.dataset == "synthetic":
        ds = data.SyntheticDataset(cfg, length=args.dump_len, seed=7)
    elif args.dataset == "oxford":
        ds = data.OxfordLoader(args.dataroot, "val_random_Ry", cfg)
    else:
        loader = {"kitti": data.KittiLoader,
                  "nuscenes": data.NuScenesLoader}[args.dataset]
        ds = loader(args.dataroot, "val", cfg)
        ds.mode = "val_random_Ry"

    # --classify-n: the network runs at its trained point count on shuffled
    # subsets; the dump (cloud, labels) stays at cfg.input_pt_num
    ecfg = (cfg.replace(input_pt_num=args.classify_n) if args.classify_n
            else cfg)
    engine = Engine(ecfg, device=args.device)
    state = engine.init_state(seed=0)
    if args.checkpoint:
        load_detector_npz(state, args.checkpoint)
    if args.classify_n:
        engine = SubsampleEnsemble(engine, seed=0,
                                   repeats=args.classify_repeats)
    coarse_acc, fine_acc = dump_predictions(
        engine, data.BatchLoader(ds, cfg.batch_size, shuffle=False,
                                 num_workers=args.workers), cfg,
        args.out, state=state, max_batches=args.max_batches,
        save_images=args.save_images, inside_threshold=args.inside_threshold,
        save_probs=args.save_probs)
    out = {"coarse_accuracy": coarse_acc, "fine_accuracy": fine_acc}
    print(json.dumps(out))
    return out


def solve(args):
    from .harness import evaluate_registration
    summ = evaluate_registration(
        args.data_dir, method=args.method, H=args.img_h, W=args.img_w,
        stride=args.stride, n_inits=args.n_inits, max_iter=args.max_iter,
        use_labels=args.use_labels, pseudo_dir=args.pseudo_dir,
        save_dir=args.save_dir, enu2cam=args.enu2cam,
        outside_weight=args.outside_weight,
        inside_threshold=args.inside_threshold,
        icp_coarse_threshold=args.icp_coarse_threshold,
        icp_seed=args.icp_seed, device=args.device)
    if args.debug_vis:
        from .debug_vis import debug_report
        from .dump import list_dump_prefixes
        for p in list_dump_prefixes(args.data_dir)[:args.debug_vis_max]:
            r = debug_report(args.data_dir, p, H=args.img_h, W=args.img_w,
                             out_dir=args.debug_vis,
                             use_labels=args.use_labels, device=args.device)
            print(json.dumps({"debug_vis": r}))
    print(json.dumps(summ, indent=2))
    return summ


def main(argv=None):
    p = argparse.ArgumentParser(description="DeepI2P port evaluation")
    sub = p.add_subparsers(dest="cmd", required=True)
    _dump_args(sub.add_parser("dump",
                              help="inference dump in the npy contract"))
    _depth_dump_args(sub.add_parser(
        "depth-dump", help="estimated-depth pseudo point clouds for ICP "
                           "(the reference's save_depth_map.py stage)"))
    _solve_args(sub.add_parser("solve",
                               help="registration over a dump directory"))
    args = p.parse_args(argv)
    return {"dump": dump, "depth-dump": depth_dump,
            "solve": solve}[args.cmd](args)


if __name__ == "__main__":
    main()
