"""Evaluation entry point of the port:

    python -m deepi2p_tpu_torch.eval.cli solve --data-dir runs/dump \
        --method frustum --img-h 384 --img-w 640 [--device cpu]

``solve`` runs a registration method over a dump directory (written by
:func:`deepi2p_tpu_torch.eval.dump.dump_predictions` or by the JAX
package) and prints the RTE/RRE/success summary as JSON.  The flags are
the JAX package's ``eval.cli solve`` flags plus ``--device`` (default the
card).  The ``dump`` and ``depth-dump`` subcommands need the checkpoint
and DepthNet slices of the port and are not here yet (``ROADMAP.md`` A).
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="DeepI2P port evaluation")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("solve", help="registration over a dump directory")
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
    s.add_argument("--device", default="cuda",
                   help="torch device of the solvers (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

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
    print(json.dumps(summ, indent=2))
    return summ


if __name__ == "__main__":
    main()
