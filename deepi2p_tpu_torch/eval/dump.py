"""Inference dump in the reference's npy contract, counterpart of the JAX
package's ``eval/dump.py`` (reference
``evaluation/visualize_and_save_data.py:94-186``).  Per sample:

    {prefix}_pc_label.npy   -- (7, N) f32: xyz, coarse_pred, coarse_label,
                                            fine_pred, fine_label
    {prefix}_K.npy          -- (3, 3) f32
    {prefix}_P.npy          -- (3, 4) f32 ground-truth pose

and optionally ``{prefix}_p.npy`` (N,) inside probabilities and
``{prefix}_img.npy`` the input image.  The files are byte for byte what
the JAX package writes, so dumps flow between the two packages and into
the reference's solvers.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.projection import generate_labels

INPUT_KEYS = ("pc", "intensity", "sn", "node_a", "node_b", "img")


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


@torch.no_grad()
def dump_predictions(model: torch.nn.Module, batches: Iterable[Dict],
                     cfg: Config, out_dir: str, *,
                     max_batches: Optional[int] = None,
                     save_images: bool = False,
                     inside_threshold: Optional[float] = None,
                     save_probs: bool = False):
    """Run the detector over ``batches`` and write per-sample dumps.

    ``model`` is the port's ``KeypointDetector`` (on the card or the CPU;
    each batch, a dict of arrays as ``synthetic_batch`` gives them, is
    moved to its device).  The coarse decision is the argmax of the coarse
    logits and the fine one the argmax of the fine logits, as the JAX
    ``Engine._infer_impl`` (``engine.py:167-176``);
    ``inside_threshold`` (0..1) replaces the coarse argmax with
    ``p_inside > threshold``.  ``save_probs`` also writes
    ``{prefix}_p.npy`` (the coarse softmax's inside probability, and the
    coarse decision becomes ``p_inside > 0.5``, the same argmax),
    ``save_images`` ``{prefix}_img.npy``.

    Returns (coarse_accuracy, fine_accuracy) over the dumped set
    (``visualize_and_save_data.py:141-148,216-217``).
    """
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    n_total = n_coarse_ok = n_inside = n_fine_ok = 0
    idx = 0
    for bi, batch in enumerate(batches):
        if max_batches is not None and bi >= max_batches:
            break
        tb = {k: torch.as_tensor(np.asarray(batch[k])).to(dev)
              for k in (*INPUT_KEYS, "P", "K")}
        coarse_logits, fine_logits = model(*(tb[k] for k in INPUT_KEYS))
        fine_pred = torch.argmax(fine_logits, dim=-1)
        p_inside = None
        if inside_threshold is not None or save_probs:
            p_inside = torch.softmax(coarse_logits.float(), dim=-1)[..., 1]
        if inside_threshold is not None:
            coarse_pred = p_inside > inside_threshold
        elif p_inside is not None:
            coarse_pred = p_inside > 0.5
        else:
            coarse_pred = torch.argmax(coarse_logits, dim=-1)
        labels = generate_labels(tb["pc"], tb["P"], tb["K"], cfg.img_H,
                                 cfg.img_W, cfg.img_fine_resolution_scale)
        coarse_pred = coarse_pred.to(torch.int32).cpu().numpy()
        fine_pred = fine_pred.to(torch.int32).cpu().numpy()
        coarse_lab = labels.coarse.cpu().numpy()
        fine_lab = labels.fine.cpu().numpy()
        if p_inside is not None:
            p_inside = p_inside.cpu().numpy()
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
            idx += 1
    return n_coarse_ok / max(n_total, 1), n_fine_ok / max(n_inside, 1)
