"""Registration evaluation harness, counterpart of the JAX package's
``eval/harness.py`` (reference ``evaluation/registration_lsq.py:251-401``,
``icp/registration_icp.py``, ``registration_random.py`` and
``registration_result_analysis.py``): given dumped predictions, run a
solver over all pairs, compute RTE/RRE and the RTE < 2 m & RRE < 5 deg
success rate, and optionally save ``P_pred_all_np.npy`` /
``P_gt_all_np.npy`` / ``cost_all_np.npy`` like the reference.

Methods: ``frustum`` (the frustum LM, kernel on the card), ``pnp``
(RANSAC PnP over the fine labels, PyTorch ops), ``icp`` (batched ICP,
1-NN kernel on the card) and ``random`` (numpy draws, the same as the JAX
package's for the same seed).  The frustum and ICP inits and the PnP
hypotheses' minimal sets come from CPU ``torch.Generator``s seeded from
``seed``, so the card and the CPU draw the same; they are not
``jax.random``'s numbers.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..register.frustum import solve_frustum_batch
from ..register.icp import icp_batch
from ..register.metrics import pose_diff_np, registration_summary
from ..register.pnp import solve_pnp_batch
from .dump import list_dump_prefixes, load_dump

METHODS = ("frustum", "pnp", "icp", "random")


def random_pose_baseline(n: int, rng: np.random.Generator, *,
                         is_2d: bool = True):
    """Random pose draws (``evaluation/registration_random.py:117-128``)."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        ry = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(ry), np.sin(ry)
        out[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        out[i, 0, 3] = rng.uniform(-5, 5)
        out[i, 2, 3] = rng.uniform(-10, 10)
        if not is_2d:
            out[i, 1, 3] = rng.uniform(-1, 1)
    return out


def _stack(chunk, field, dev, dtype=torch.float32):
    return torch.as_tensor(np.stack([d[field] for d in chunk])).to(dev,
                                                                   dtype)


def evaluate_registration(data_dir: str, *, method: str = "frustum",
                          H: int, W: int, stride: int = 1,
                          use_labels: bool = False,
                          batch_size: int = 16, n_inits: int = 60,
                          max_iter: int = 32, seed: int = 0,
                          pseudo_dir: Optional[str] = None,
                          save_dir: Optional[str] = None,
                          enu2cam: bool = False,
                          outside_weight: float = 1.0,
                          edge_margin_px: float = 0.0,
                          inside_threshold: Optional[float] = None,
                          confidence_gamma: Optional[float] = None,
                          icp_coarse_threshold: Optional[float] = None,
                          icp_seed: str = "none",
                          probe_stride: Optional[int] = None,
                          survivors: Optional[int] = None,
                          device="cuda") -> Dict[str, float]:
    """Run a solver over a dump directory and summarise RTE/RRE/success.

    Args:
      method: 'frustum' | 'pnp' | 'icp' | 'random'.
      stride: evaluate every ``stride``-th pair.
      use_labels: solve from the GT labels instead of the predictions
        (the reference's solver oracle mode).
      pseudo_dir: ``{prefix}_pc.npy`` pseudo clouds for 'icp'
        (:mod:`deepi2p_tpu_torch.eval.dump` / ``eval.depth``).
      enu2cam: convert ENU-frame dumps (nuScenes) to the camera convention
        first (``registration_lsq.py:237-248``).
      outside_weight / edge_margin_px: weighted or margin-relaxed frustum
        cost (1.0 / 0.0 = the reference cost).
      inside_threshold: re-derive ``coarse_pred`` as ``p_inside > t`` from
        dumps written with ``save_probs``.
      confidence_gamma: weight each point's frustum block by
        ``|2 p_inside - 1| ** gamma`` (needs ``save_probs`` dumps).
      icp_coarse_threshold: multi-scale ICP anneal start in metres.
      icp_seed: 'none' (blind draws) or 'frustum' (half the ICP inits
        around the frustum solution from the same predictions).
      probe_stride / survivors: successive-halving knobs of
        :func:`solve_frustum_batch` (frustum only), forwarded only when
        given, as the JAX harness does.
      device: where the solvers run (the card unless the caller names the
        CPU).
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    dev = resolve_device(device)
    prefixes = list_dump_prefixes(data_dir)[::stride]
    dumps = [load_dump(data_dir, p) for p in prefixes]
    if inside_threshold is not None or confidence_gamma is not None:
        missing = [p for p, d in zip(prefixes, dumps) if "p_inside" not in d]
        if missing:
            raise ValueError(
                f"inside_threshold/confidence_gamma need {{prefix}}_p.npy "
                f"(dump with save_probs); missing for {missing[:3]}...")
    if inside_threshold is not None:
        for d in dumps:
            d["coarse_pred"] = (d["p_inside"]
                                > inside_threshold).astype(np.int32)
    if enu2cam:
        from ..data.nuscenes import enu2cam as _enu2cam
        for d in dumps:
            d["pc"], d["P"] = _enu2cam(d["pc"], d["P"])

    n = len(dumps)
    P_pred_all = np.zeros((n, 4, 4))
    P_gt_all = np.stack([d["P"] for d in dumps]) if n else np.zeros((0, 4, 4))
    cost_all = np.zeros(n)
    chunks = [(s, dumps[s:s + batch_size]) for s in range(0, n, batch_size)]

    if method == "random":
        P_pred_all = random_pose_baseline(n, np.random.default_rng(seed))
    elif method in ("frustum", "pnp"):
        gen = torch.Generator().manual_seed(seed)
        field = "coarse_label" if use_labels else "coarse_pred"
        ffield = "fine_label" if use_labels else "fine_pred"
        knobs = {k: v for k, v in (("probe_stride", probe_stride),
                                   ("survivors", survivors)) if v is not None}
        for start, chunk in chunks:
            pc = _stack(chunk, "pc", dev)
            coarse = _stack(chunk, field, dev, torch.int64)
            K = _stack(chunk, "K", dev)
            if method == "pnp":
                res = solve_pnp_batch(
                    pc, coarse, _stack(chunk, ffield, dev, torch.int64), K,
                    gen, W_fine=int(round(W / 32)))
                P, cost = res.P, res.cost
            else:
                pw = None
                if confidence_gamma is not None:
                    p_in = np.stack([d["p_inside"] for d in chunk])
                    pw = torch.as_tensor(np.abs(2.0 * p_in - 1.0)
                                         ** confidence_gamma).to(
                                             dev, torch.float32)
                P, cost = solve_frustum_batch(
                    pc, coarse, K, H=H, W=W, generator=gen, n_inits=n_inits,
                    max_iter=max_iter, outside_weight=outside_weight,
                    edge_margin_px=edge_margin_px, point_weights=pw, **knobs)
            P_pred_all[start:start + len(chunk)] = P.cpu().numpy()
            cost_all[start:start + len(chunk)] = cost.cpu().numpy()
    else:
        P_seed_all = None
        if icp_seed == "frustum":
            # seed poses: the frustum solution from the same predictions
            # at the reference budget
            P_seed_all = np.zeros((n, 4, 4), np.float32)
            gen_s = torch.Generator().manual_seed(seed + 9000)
            for start, chunk in chunks:
                P_s, _ = solve_frustum_batch(
                    _stack(chunk, "pc", dev),
                    _stack(chunk, "coarse_pred", dev, torch.int64),
                    _stack(chunk, "K", dev), H=H, W=W, generator=gen_s,
                    n_inits=60, max_iter=32)
                P_seed_all[start:start + len(chunk)] = P_s.cpu().numpy()
        pseudos = []
        for prefix, d in zip(prefixes, dumps):
            pseudo = np.load(os.path.join(pseudo_dir,
                                          prefix + "_pc.npy")).T  # (M, 3)
            # depth-scale calibration against the GT-visible mean depth
            # (``registration_icp.py:216-219``): the inside mask of the GT
            # pose, never the predictions
            cam = d["pc"] @ d["P"][:3, :3].T + d["P"][:3, 3]
            inside = d["coarse_label"].astype(np.float32)
            mean_gt = (np.sum(cam[:, 2] * inside)
                       / max(np.sum(inside), 1.0))
            s = mean_gt / max(float(np.mean(pseudo[:, 2])), 1e-6)
            pseudos.append(pseudo.astype(np.float32) * s)
        # padded to a common size with a far sentinel that never wins a
        # nearest-neighbour race nor counts as an inlier
        M_max = max(p.shape[0] for p in pseudos)
        target = np.full((n, M_max, 3), 1e6, np.float32)
        for i, p in enumerate(pseudos):
            target[i, :p.shape[0]] = p
        gen = torch.Generator().manual_seed(seed)
        for start, chunk in chunks:
            res = icp_batch(
                np.stack([d["pc"] for d in chunk]).astype(np.float32),
                target[start:start + len(chunk)], gen, n_inits=n_inits,
                max_iter=max_iter, coarse_threshold=icp_coarse_threshold,
                P_seed=(None if P_seed_all is None else
                        P_seed_all[start:start + len(chunk)]),
                device=dev)
            P_pred_all[start:start + len(chunk)] = res.P.cpu().numpy()
            cost_all[start:start + len(chunk)] = res.fitness.cpu().numpy()

    rte = np.zeros(n)
    rre = np.zeros(n)
    for i in range(n):
        rte[i], rre[i] = pose_diff_np(P_pred_all[i], P_gt_all[i])

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, "P_pred_all_np.npy"), P_pred_all)
        np.save(os.path.join(save_dir, "P_gt_all_np.npy"), P_gt_all)
        np.save(os.path.join(save_dir, "cost_all_np.npy"), cost_all)
    return registration_summary(rte, rre)
