"""Trained weights for the port: the read side of the JAX package's
``train/checkpoint.py::export_npz`` (``:63-76``).

An exported ``.npz`` holds ``__step__`` and one array per leaf of the flax
``params`` and ``batch_stats`` trees, keyed by the leaf's flattened path,
such as ``params['img_encoder']['backbone']['bn1']['bias']``.
:func:`load_npz` parses those keys back into nested dicts (no
``jax.tree_util``); :func:`load_detector_npz` feeds them through
:func:`~deepi2p_tpu_torch.models.from_jax.state_dict_from_flax` into a
``KeypointDetector``.  Loading is strict, as the JAX package's
``warm_start_npz(partial=False)``: a leaf the mapping looks for and the
file lacks raises a ``KeyError`` that names its key, a parameter of the
detector that the file does not fill raises a ``KeyError`` that names the
parameter, and a shape that differs raises a ``ValueError`` that names the
parameter and both shapes.  The partial, cross-geometry warm start belongs
to training and comes with it (``ROADMAP.md`` A.9).
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
from torch import nn

from ..models.from_jax import load_state_dict, state_dict_from_flax

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


def load_npz(path: str) -> Tuple[Dict, Dict, int]:
    """An ``export_npz`` file -> (params, batch_stats, step): nested dicts
    of numpy arrays, as the flax trees hold them."""
    trees = {root: _Tree(root) for root in ROOTS}
    with np.load(path) as z:
        if "__step__" not in z.files:
            raise KeyError(f"{path}: no __step__, not an export_npz file")
        step = int(z["__step__"])
        for key in z.files:
            if key == "__step__":
                continue
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
            node[parts[-1]] = z[key]
    return trees["params"], trees["batch_stats"], step


def load_detector_npz(model: nn.Module, path: str) -> int:
    """Load an ``export_npz`` checkpoint into the port's
    ``KeypointDetector`` (strict, see the module docstring); returns the
    checkpoint's training step."""
    params, batch_stats, step = load_npz(path)
    load_state_dict(model, state_dict_from_flax(params, batch_stats))
    return step
