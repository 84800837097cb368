"""Checkpoints of the port, counterpart of the JAX package's
``train/checkpoint.py``.

Two formats:

* The JAX package's ``export_npz`` file: ``__step__`` and one array per
  leaf of the flax ``params`` and ``batch_stats`` trees, keyed by the
  leaf's flattened path, such as
  ``params['img_encoder']['backbone']['bn1']['bias']``.  :func:`export_npz`
  writes it from a port state (through
  :func:`~deepi2p_tpu_torch.models.from_jax.flax_from_state_dict`), so
  weights trained here load in the JAX package and in either ``eval.cli
  dump``.  :func:`load_npz` parses the keys back into nested dicts (no
  ``jax.tree_util``) and :func:`load_detector_npz` loads them into a
  ``KeypointDetector`` strictly, as the JAX package's
  ``warm_start_npz(partial=False)``: a leaf the mapping looks for and the
  file lacks raises a ``KeyError`` that names its key, a parameter of the
  detector that the file does not fill raises a ``KeyError`` that names
  the parameter, and a shape that differs raises a ``ValueError`` that
  names the parameter and both shapes.  :func:`warm_start_npz` rebuilds a
  train state with the JAX rules, strict or partial (cross-geometry).
* :class:`CheckpointManager`: full train states (model, Adam moments,
  step) in the port's own format, one ``torch.save`` file per step (orbax
  is JAX's), written to a temporary file and renamed into place, with
  orbax's ``max_to_keep`` and ``keep_period`` retention.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.from_jax import (flax_from_state_dict, load_state_dict,
                               state_dict_from_flax)
from .engine import TrainState, model_of

# the least share of leaves a partial warm start must transfer: below it,
# key naming or geometry has drifted and the start would be near-cold
MIN_TRANSFER_FRAC = 0.8

ROOTS = ("params", "batch_stats")
_PART = re.compile(r"\['([^'\]]*)'\]")


class _Tree(dict):
    """One node of a parsed tree; a lookup that misses names the full
    key."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def __missing__(self, key):
        raise KeyError(f"{self.path}['{key}']: missing from the checkpoint")


def _unflatten(items: Iterable[Tuple[str, np.ndarray]]) -> Tuple[Dict, Dict]:
    """(flattened key, array) pairs -> (params, batch_stats) nested dicts."""
    trees = {root: _Tree(root) for root in ROOTS}
    for key, value in items:
        root, _, rest = key.partition("[")
        parts = _PART.findall("[" + rest)
        if (root not in trees or not parts
                or "".join(f"['{p}']" for p in parts) != "[" + rest):
            raise ValueError(f"{key}: not a flattened params or "
                             "batch_stats path")
        node = trees[root]
        for p in parts[:-1]:
            if p not in node:
                dict.__setitem__(node, p, _Tree(f"{node.path}['{p}']"))
            node = node[p]
        node[parts[-1]] = value
    return trees["params"], trees["batch_stats"]


def load_npz(path: str) -> Tuple[Dict, Dict, int]:
    """An ``export_npz`` file -> (params, batch_stats, step): nested dicts
    of numpy arrays, as the flax trees hold them."""
    with np.load(path) as z:
        if "__step__" not in z.files:
            raise KeyError(f"{path}: no __step__, not an export_npz file")
        step = int(z["__step__"])
        params, stats = _unflatten((k, z[k]) for k in z.files
                                   if k != "__step__")
    return params, stats, step


def load_detector_npz(target, path: str) -> int:
    """Load an ``export_npz`` checkpoint into the port's
    ``KeypointDetector`` or a :class:`TrainState`'s model (strict, see the
    module docstring); returns the checkpoint's training step."""
    params, batch_stats, step = load_npz(path)
    load_state_dict(model_of(target),
                    state_dict_from_flax(params, batch_stats))
    return step


def flat_arrays(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and statistics as ``export_npz`` keys ->
    f32 numpy arrays, keys sorted (the order ``jax.tree_util`` flattens
    dicts in)."""
    params, stats = flax_from_state_dict(model.state_dict(),
                                         model.cfg.normalization)
    return {**flatten_tree("params", params),
            **flatten_tree("batch_stats", stats)}


def flatten_tree(root: str, tree: Dict) -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> ``export_npz`` keys
    (``root['a']['b']``), keys sorted at every level."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(f"{prefix}['{k}']", node[k])
            else:
                out[f"{prefix}['{k}']"] = node[k]
    walk(root, tree)
    return out


def export_npz(state: TrainState, path: str) -> None:
    """Write params + batch_stats + step to one ``.npz`` with the JAX
    package's keys (temporary file, then ``os.replace``)."""
    arrays = {"__step__": np.asarray(state.step, np.int32),
              **flat_arrays(state.model)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def warm_start_npz(state: TrainState, path: str,
                   partial: bool = False) -> TrainState:
    """Rebuild ``state`` from an :func:`export_npz` file (either
    package's), with the JAX package's rules: fresh Adam moments; strict
    by default (a missing leaf or a shape that differs raises
    ``ValueError``); ``partial=True`` transfers every leaf whose shape
    matches, keeps the state's own values for the rest (cross-geometry
    transfer, such as a fine head whose class count differs), resets the
    step to 0, and raises when less than ``MIN_TRANSFER_FRAC`` of the
    leaves transfer."""
    own = flat_arrays(state.model)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    merged: Dict[str, np.ndarray] = {}
    skipped: List[Tuple[str, Optional[tuple], tuple]] = []
    for key, leaf in own.items():
        arr = arrays.get(key)
        if arr is None or arr.shape != leaf.shape:
            if not partial:
                raise ValueError(
                    f"{key}: snapshot "
                    f"{'missing' if arr is None else arr.shape} != "
                    f"template {leaf.shape}")
            skipped.append((key, None if arr is None else arr.shape,
                            leaf.shape))
            merged[key] = leaf
            continue
        merged[key] = arr.astype(leaf.dtype)
    n_total = len(own)
    n_transferred = n_total - len(skipped)
    if skipped:
        print(f"warm_start_npz: kept template init for {len(skipped)} "
              "shape-mismatched/missing leaves:")
        for key, got, want in skipped:
            print(f"  {key}: snapshot {got} != template {want}")
    print(f"warm_start_npz: transferred {n_transferred}/{n_total} leaves "
          f"from {path}")
    if partial and n_total and n_transferred / n_total < MIN_TRANSFER_FRAC:
        raise ValueError(
            f"warm_start_npz(partial=True): only {n_transferred}/{n_total} "
            f"leaves matched ({n_transferred / n_total:.0%} < "
            f"{MIN_TRANSFER_FRAC:.0%}): key naming or geometry has "
            "drifted and this would be a near-cold start.")
    params, stats = _unflatten(merged.items())
    load_state_dict(state.model, state_dict_from_flax(params, stats))
    state.step = 0 if partial else int(arrays["__step__"])
    state.reset_optimizer()
    return state


class CheckpointManager:
    """Full train-state checkpoints in ``directory``, one
    ``ckpt_<step>.pt`` per saved step."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 5,
                 keep_period: Optional[int] = None):
        """``keep_period``: also retain every checkpoint whose step is a
        multiple of it, outside the ``max_to_keep`` window, so frequent
        mid-epoch saves (``--ckpt-every``) cannot evict the epoch-boundary
        history."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            self._NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, *, metrics: Optional[dict] = None):
        names = [n for n, _ in state.model.named_parameters()]
        payload = {
            "step": int(state.step),
            "model": {k: v.detach().cpu()
                      for k, v in state.model.state_dict().items()},
            "mu": {n: t.detach().cpu() for n, t in zip(names, state.mu)},
            "nu": {n: t.detach().cpu() for n, t in zip(names, state.nu)},
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        path = self._path(int(state.step))
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep] if self.max_to_keep else []:
            if not (self.keep_period and step % self.keep_period == 0):
                os.remove(self._path(step))

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a saved step (default: the latest) into ``state`` (strict:
        the model's state_dict and the moments of every parameter)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        model = state.model
        load_state_dict(model, payload["model"])
        names = [n for n, _ in model.named_parameters()]
        if not set(names) == set(payload["mu"]) == set(payload["nu"]):
            raise KeyError(f"{self._path(step)}: the Adam moments do not "
                           "name the model's parameters")
        dev = next(model.parameters()).device
        state.mu = [payload["mu"][n].to(dev) for n in names]
        state.nu = [payload["nu"][n].to(dev) for n in names]
        state.step = int(payload["step"])
        return state
