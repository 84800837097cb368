"""The inference half of the JAX package's ``train/engine.py::Engine``
(``:167-205``, public ``:221-228``).

The JAX engine's state is a pytree of params and batch statistics; here
it is the ``KeypointDetector`` module itself, in eval mode, on the
engine's device.  ``infer``, ``infer_probs`` and ``infer_probs_fine`` take
``(state, batch)`` as the JAX methods do, move the batch's inputs (numpy
arrays or tensors) to the device, and return tensors there: the argmax
labels, the inside probability with the fine argmax, and the inside
probability with the full fine softmax.  Training steps come with the
training slice (``ROADMAP.md`` A.9).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import Config
from ..device import resolve_device
from ..models.detector import INPUT_KEYS, KeypointDetector, build_detector


class Engine:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0) -> KeypointDetector:
        """A detector with seeded weights on the engine's device (load a
        checkpoint into it with ``train.checkpoint.load_detector_npz``)."""
        return build_detector(self.cfg, device=self.device, seed=seed)

    @torch.no_grad()
    def _forward(self, state: KeypointDetector, batch: Dict):
        return state(*(torch.as_tensor(batch[k], device=self.device)
                       for k in INPUT_KEYS))

    def infer(self, state, batch):
        """Argmax labels: (coarse (B, N), fine (B, N)), or the coarse only
        without the fine head (``multimodal_classifier.py:100-117``)."""
        out = self._forward(state, batch)
        if self.cfg.is_fine_resolution:
            coarse, fine = out
            return torch.argmax(coarse, dim=-1), torch.argmax(fine, dim=-1)
        return torch.argmax(out, dim=-1)

    def infer_probs(self, state, batch):
        """(p_inside (B, N) f32, fine argmax (B, N) or None)."""
        out = self._forward(state, batch)
        if self.cfg.is_fine_resolution:
            coarse, fine = out
            return (torch.softmax(coarse, dim=-1)[..., 1],
                    torch.argmax(fine, dim=-1))
        return torch.softmax(out, dim=-1)[..., 1], None

    def infer_probs_fine(self, state, batch):
        """(p_inside (B, N) f32, fine softmax (B, N, C) f32 or None): the
        full fine distribution, which the subset ensemble averages."""
        out = self._forward(state, batch)
        if self.cfg.is_fine_resolution:
            coarse, fine = out
            return (torch.softmax(coarse, dim=-1)[..., 1],
                    torch.softmax(fine, dim=-1))
        return torch.softmax(out, dim=-1)[..., 1], None
