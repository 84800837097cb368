"""Inference dump in the reference's npy contract, counterpart of the JAX
package's ``eval/dump.py`` (reference
``evaluation/visualize_and_save_data.py:94-186``).  Per sample:

    {prefix}_pc_label.npy   -- (7, N) f32: xyz, coarse_pred, coarse_label,
                                            fine_pred, fine_label
    {prefix}_K.npy          -- (3, 3) f32
    {prefix}_P.npy          -- (3, 4) f32 ground-truth pose

and optionally ``{prefix}_p.npy`` (N,) inside probabilities and
``{prefix}_img.npy`` the input image; ``viz_dir`` receives the PNGs
``{prefix}_img.png`` and ``{prefix}_prediction.png`` (the TP/FP/FN
overlay of :func:`~..utils.vis.classification_overlay`).  The files are byte for byte what
the JAX package writes, so dumps flow between the two packages and into
the reference's solvers.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..models.detector import INPUT_KEYS
from ..ops.projection import generate_labels
from ..train.engine import Engine


def save_sample_dump(out_dir: str, prefix: str, *, pc: np.ndarray,
                     coarse_pred: np.ndarray, coarse_label: np.ndarray,
                     fine_pred: np.ndarray, fine_label: np.ndarray,
                     K: np.ndarray, P: np.ndarray):
    """pc is (N, 3); stored transposed to match the (7, N) contract."""
    data = np.concatenate([
        pc.T.astype(np.float32),
        coarse_pred[None].astype(np.float32),
        coarse_label[None].astype(np.float32),
        fine_pred[None].astype(np.float32),
        fine_label[None].astype(np.float32),
    ], axis=0)
    np.save(os.path.join(out_dir, prefix + "_pc_label.npy"), data)
    np.save(os.path.join(out_dir, prefix + "_K.npy"), K.astype(np.float32))
    np.save(os.path.join(out_dir, prefix + "_P.npy"), P.astype(np.float32))


def load_dump(data_dir: str, prefix: str):
    """-> dict(pc (N,3), coarse_pred, coarse_label, fine_pred, fine_label,
    K (3,3), P (4,4)[, p_inside (N,)])."""
    d = np.load(os.path.join(data_dir, prefix + "_pc_label.npy"))
    K = np.load(os.path.join(data_dir, prefix + "_K.npy"))
    P = np.load(os.path.join(data_dir, prefix + "_P.npy"))
    if P.shape[0] == 3:
        P = np.concatenate([P, np.eye(4)[3:4]], axis=0)
    out = dict(pc=d[0:3].T, coarse_pred=d[3].astype(np.int32),
               coarse_label=d[4].astype(np.int32),
               fine_pred=d[5].astype(np.int32),
               fine_label=d[6].astype(np.int32),
               K=K.astype(np.float64), P=P.astype(np.float64))
    p_path = os.path.join(data_dir, prefix + "_p.npy")
    if os.path.isfile(p_path):
        out["p_inside"] = np.load(p_path).astype(np.float32)
    return out


def list_dump_prefixes(data_dir: str):
    names = {f[:9] for f in os.listdir(data_dir)
             if os.path.isfile(os.path.join(data_dir, f))}
    return sorted(names)


class SubsampleEnsemble:
    """Subset-ensemble inference, the JAX package's ``SubsampleEnsemble``
    (``eval/dump.py:71-190``): classify an N-point cloud with a network
    trained at ``sub_n = cfg.input_pt_num < N`` points.

    Each of ``repeats`` covers splits every cloud into ``ceil(N / sub_n)``
    shuffled subsets of exactly ``sub_n`` points (a permutation padded by
    wrapping around), draws the nodes from each subset, classifies each
    subset at the trained density and averages the per-point inside
    probabilities over the takes that hold the point.  With an engine that
    has ``infer_probs_fine`` the fine decision is the argmax of the
    accumulated per-cell softmax; otherwise the last take's fine cell.

    The draws come from ``numpy.random.default_rng(seed)`` in the JAX
    package's order (the per-sample permutations of every cover, then two
    node draws per take), so the same seed gives the JAX package's subsets
    and nodes.  The gathers and the accumulation run on the engine's
    device.  It exposes the engine's ``infer_probs`` / ``infer``, so
    :func:`dump_predictions` takes it as the engine.
    """

    def __init__(self, engine, *, seed: int = 0, repeats: int = 1):
        self.engine = engine
        self.cfg = engine.cfg
        self.device = getattr(engine, "device", torch.device("cpu"))
        self.repeats = max(1, int(repeats))
        self._rng = np.random.default_rng(seed)

    @torch.no_grad()
    def infer_probs(self, state, batch):
        """(p_inside (B, N) f32, fine (B, N) int64 or None), on the
        engine's device."""
        dev = self.device
        inputs = {k: torch.as_tensor(v, device=dev)
                  for k, v in batch.items()}
        B, N = inputs["pc"].shape[:2]
        sub_n = self.cfg.input_pt_num
        n_sub = -(-N // sub_n)
        ma, mb = self.cfg.node_a_num, self.cfg.node_b_num

        p_sum = torch.zeros(B, N, dtype=torch.float64, device=dev)
        cnt = torch.zeros(B, N, dtype=torch.float64, device=dev)
        fine = torch.zeros(B, N, dtype=torch.int64, device=dev)
        fine_sum = None
        use_fine_probs = hasattr(self.engine, "infer_probs_fine")
        have_fine = False
        takes = []
        for _ in range(self.repeats):
            idx = np.stack([self._rng.permutation(N) for _ in range(B)])
            total = n_sub * sub_n
            reps = -(-total // N)
            idx = np.tile(idx, (1, reps))[:, :total].reshape(B, n_sub, sub_n)
            takes.extend(idx[:, s] for s in range(n_sub))

        def gather(x, ix):
            return torch.gather(x, 1, ix[..., None].expand(-1, -1,
                                                           x.shape[-1]))

        for take_np in takes:
            take = torch.as_tensor(take_np, device=dev)
            na = torch.as_tensor(self._rng.integers(0, sub_n, (B, ma)),
                                 device=dev)
            nb = torch.as_tensor(self._rng.integers(0, sub_n, (B, mb)),
                                 device=dev)
            sub = dict(inputs)
            for k in ("pc", "intensity", "sn"):
                sub[k] = gather(inputs[k], take)
            sub["node_a"] = gather(sub["pc"], na)
            sub["node_b"] = gather(sub["pc"], nb)
            if use_fine_probs:
                p_s, fine_s = self.engine.infer_probs_fine(state, sub)
            else:
                p_s, fine_s = self.engine.infer_probs(state, sub)
            p_s = torch.as_tensor(p_s, device=dev).to(torch.float64)
            # read-modify-write puts, as the JAX package's put_along_axis:
            # a point twice in one take (sub_n > N) counts once there
            cnt.scatter_(1, take, torch.gather(cnt, 1, take) + 1.0)
            p_sum.scatter_(1, take, torch.gather(p_sum, 1, take) + p_s)
            if fine_s is None:
                continue
            have_fine = True
            fine_s = torch.as_tensor(fine_s, device=dev)
            if use_fine_probs:
                fine_p = fine_s.to(torch.float32)
                if fine_sum is None:
                    fine_sum = torch.zeros(B, N, fine_p.shape[-1],
                                           dtype=torch.float32, device=dev)
                ix = take[..., None].expand(-1, -1, fine_p.shape[-1])
                fine_sum.scatter_(1, ix, torch.gather(fine_sum, 1, ix)
                                  + fine_p)
            else:
                fine.scatter_(1, take, fine_s.to(torch.int64))
        p = (p_sum / torch.clamp(cnt, min=1.0)).to(torch.float32)
        if fine_sum is not None:
            fine = torch.argmax(fine_sum, dim=-1)
        return p, (fine if have_fine else None)

    def infer(self, state, batch):
        """The probability thresholded at 0.5 (the binary argmax of the
        averaged softmax), and the fine decision."""
        p, fine = self.infer_probs(state, batch)
        return (p > 0.5).to(torch.int64), fine


@torch.no_grad()
def dump_predictions(engine, batches: Iterable[Dict], cfg: Config,
                     out_dir: str, *, state=None,
                     max_batches: Optional[int] = None,
                     viz_dir: Optional[str] = None,
                     save_images: bool = False,
                     inside_threshold: Optional[float] = None,
                     save_probs: bool = False):
    """Run inference over ``batches`` and write per-sample dumps, as the
    JAX package's ``dump_predictions`` (``eval/dump.py:193-``).

    ``engine`` is an :class:`~deepi2p_tpu_torch.train.engine.Engine` or a
    :class:`SubsampleEnsemble` with its ``state`` (the detector), or a bare
    ``KeypointDetector``, which then is the state of an engine on its
    device.  Each batch is a dict of arrays as ``synthetic_batch`` or the
    ``BatchLoader`` gives them.  The coarse decision is the engine's
    argmax; ``inside_threshold`` (0..1) replaces it with ``p_inside >
    threshold``.  ``save_probs`` also writes ``{prefix}_p.npy`` (the
    inside probability; the decision is then ``p_inside > 0.5``, the same
    argmax from one forward), ``save_images`` ``{prefix}_img.npy``.
    ``viz_dir`` also writes ``{prefix}_img.png`` (the input image cast to
    uint8) and ``{prefix}_prediction.png`` (the TP/FP/FN overlay), as the
    reference (``visualize_and_save_data.py:168-186``).

    Returns (coarse_accuracy, fine_accuracy) over the dumped set
    (``visualize_and_save_data.py:141-148,216-217``).
    """
    if isinstance(engine, torch.nn.Module):
        state = engine
        engine = Engine(state.cfg, device=next(state.parameters()).device)
    dev = engine.device
    os.makedirs(out_dir, exist_ok=True)
    if viz_dir:
        from ..utils.png import write_png
        from ..utils.vis import classification_overlay
        os.makedirs(viz_dir, exist_ok=True)
    n_total = n_coarse_ok = n_inside = n_fine_ok = 0
    idx = 0
    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        p_inside = None
        if inside_threshold is not None or save_probs:
            p_inside, fine_pred = engine.infer_probs(state, batch)
        if inside_threshold is not None:
            coarse_pred = p_inside > inside_threshold
        elif p_inside is not None:
            coarse_pred = p_inside > 0.5
        else:
            coarse_pred, fine_pred = engine.infer(state, batch)
        labels = generate_labels(
            *(torch.as_tensor(np.asarray(batch[k]), device=dev)
              for k in ("pc", "P", "K")),
            cfg.img_H, cfg.img_W, cfg.img_fine_resolution_scale)
        coarse_pred = coarse_pred.to(torch.int32).cpu().numpy()
        fine_pred = fine_pred.to(torch.int32).cpu().numpy()
        coarse_lab = labels.coarse.cpu().numpy()
        fine_lab = labels.fine.cpu().numpy()
        if p_inside is not None:
            p_inside = p_inside.cpu().numpy()
        pxpy = labels.pxpy.cpu().numpy() if viz_dir else None
        B, N = coarse_pred.shape
        n_total += B * N
        n_coarse_ok += int((coarse_pred == coarse_lab).sum())
        inside = coarse_lab == 1
        n_inside += int(inside.sum())
        n_fine_ok += int(((fine_pred == fine_lab) & inside).sum())
        for b in range(B):
            prefix = f"{idx:06d}_00"
            save_sample_dump(out_dir, prefix,
                             pc=np.asarray(batch["pc"][b]),
                             coarse_pred=coarse_pred[b],
                             coarse_label=coarse_lab[b],
                             fine_pred=fine_pred[b],
                             fine_label=fine_lab[b],
                             K=np.asarray(batch["K"][b]),
                             P=np.asarray(batch["P"][b]))
            if save_probs:
                np.save(os.path.join(out_dir, prefix + "_p.npy"),
                        p_inside[b].astype(np.float32))
            if save_images:
                np.save(os.path.join(out_dir, prefix + "_img.npy"),
                        np.asarray(batch["img"][b], np.float32))
            if viz_dir:
                img = np.asarray(batch["img"][b]).astype(np.uint8)
                write_png(os.path.join(viz_dir, prefix + "_img.png"), img)
                write_png(os.path.join(viz_dir, prefix + "_prediction.png"),
                          classification_overlay(
                              pxpy[b], coarse_pred[b], coarse_lab[b], img,
                              fine_pred=fine_pred[b],
                              fine_label=fine_lab[b],
                              fine_scale=cfg.img_fine_resolution_scale))
            idx += 1
    return n_coarse_ok / max(n_total, 1), n_fine_ok / max(n_inside, 1)
