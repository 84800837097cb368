"""Object-style facade over the port's engine, counterpart of the JAX
package's ``train/classifier.py``: the public surface of the reference's
``MMClassifer`` / ``MMClassiferCoarse``
(``models/multimodal_classifier.py:25-377,380-682``), ``set_input`` /
``optimize`` / ``test_model`` / ``inference_pass`` / ``save_network`` /
``load_model`` / ``update_learning_rate``, on
:class:`~.engine.Engine`.  The coarse-only variant is
``cfg.is_fine_resolution=False``.  ``write_classification_visualization``
logs the reference's TP/FP/FN overlays through the logger's ``log_image``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..models.from_jax import load_state_dict
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager
from .engine import Engine, TrainState


class MMClassifier:
    """Stateful wrapper: owns the train state, the dropout generator, the
    metrics and the checkpoints, on ``device`` (default: the card)."""

    def __init__(self, cfg: Config, *, steps_per_epoch: int = 1000,
                 log_dir: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.engine = Engine(cfg, steps_per_epoch=steps_per_epoch,
                             device=device)
        self.logger = MetricsLogger(log_dir) if log_dir else None
        self.seed = seed
        self.generator = torch.Generator(device=self.engine.device
                                         ).manual_seed(seed + 1)
        self.state: Optional[TrainState] = None
        self._batch: Optional[Dict] = None
        self.train_metrics: Dict[str, float] = {}
        self.test_metrics: Dict[str, float] = {}

    @property
    def global_step(self) -> int:
        return 0 if self.state is None else self.state.step

    def set_input(self, batch: Dict[str, np.ndarray]):
        """Stage a batch on the device (the first one also builds the
        state, ``multimodal_classifier.py:82-93``)."""
        dev = self.engine.device
        self._batch = {k: torch.as_tensor(v, device=dev)
                       for k, v in batch.items()}
        if self.state is None:
            self.state = self.engine.init_state(seed=self.seed)

    def _log(self, tag: str, metrics) -> Dict[str, float]:
        out = {k: float(v) for k, v in metrics.items()}
        if self.logger:
            self.logger.log_scalars(tag, out, self.global_step)
        return out

    def optimize(self) -> Dict[str, float]:
        """One training step on the staged batch
        (``multimodal_classifier.py:214-219``)."""
        self.state, metrics = self.engine.train_step(self.state, self._batch,
                                                     self.generator)
        self.train_metrics = self._log("train", metrics)
        return self.train_metrics

    def test_model(self) -> Dict[str, float]:
        """Evaluation pass on the staged batch (no update)."""
        metrics = self.engine.eval_step(self.state, self._batch)
        self.test_metrics = self._log("test", metrics)
        return self.test_metrics

    def inference_pass(self):
        """Argmax coarse (and fine) predictions
        (``multimodal_classifier.py:100-117``)."""
        return self.engine.infer(self.state, self._batch)

    def get_current_errors(self):
        return self.train_metrics, self.test_metrics

    def get_current_accuracy(self):
        pick = lambda d: {k: v for k, v in d.items() if "accuracy" in k}
        return pick(self.train_metrics), pick(self.test_metrics)

    def save_network(self, directory: str):
        """Full-state checkpoint (model, Adam moments, step)."""
        CheckpointManager(directory).save(self.state)

    def load_model(self, directory: str, step: Optional[int] = None):
        if self.state is None:
            raise RuntimeError("call set_input once to build the state")
        self.state = CheckpointManager(directory).restore(self.state, step)

    def load_torch_checkpoint(self, state_dict):
        """Import a reference-trained ``KeypointDetector.state_dict()``
        (the port's module names are the reference's; a ``module.``
        prefix of ``DataParallel`` and ``num_batches_tracked`` are
        dropped)."""
        sd = {k.removeprefix("module."): v for k, v in state_dict.items()
              if not k.endswith("num_batches_tracked")}
        load_state_dict(self.state.model, sd)

    @staticmethod
    def print_loss_dict(loss_dict, accuracy_dict=None, duration=-1.0):
        """Console format of ``multimodal_classifier.py:253-261``."""
        parts = [f"Per sample time: {duration:.4f} -"]
        parts += [f"{k}: {v:.4f}," for k, v in loss_dict.items()]
        if accuracy_dict:
            parts += [f"{k}: {v:.4f}," for k, v in accuracy_dict.items()]
        print(" ".join(parts))

    def write_classification_visualization(self,
                                           out_step: Optional[int] = None):
        """Project the staged batch's cloud and log the TP/FP/FN overlays
        of up to ``cfg.vis_max_batch`` samples tiled two per row
        (``multimodal_classifier.py:338-377``); returns the canvas, or
        None without a logger."""
        from ..ops.projection import generate_labels
        from ..utils.vis import classification_overlay, grid
        if self.logger is None:
            return None
        preds = self.inference_pass()
        coarse_pred, fine_pred = (preds if self.cfg.is_fine_resolution
                                  else (preds, None))
        labels = generate_labels(self._batch["pc"], self._batch["P"],
                                 self._batch["K"], self.cfg.img_H,
                                 self.cfg.img_W,
                                 self.cfg.img_fine_resolution_scale)

        def host(x):
            return None if x is None else x.detach().cpu().numpy()

        pxpy, coarse_lab, fine_lab = (host(labels.pxpy), host(labels.coarse),
                                      host(labels.fine))
        coarse_pred, fine_pred = host(coarse_pred), host(fine_pred)
        img = host(self._batch["img"])
        n = min(self.cfg.vis_max_batch, img.shape[0])
        canvas = grid([classification_overlay(
            pxpy[b], coarse_pred[b], coarse_lab[b], img[b],
            fine_pred=None if fine_pred is None else fine_pred[b],
            fine_label=fine_lab[b],
            fine_scale=self.cfg.img_fine_resolution_scale)
            for b in range(n)], cols=2)
        self.logger.log_image("classification", canvas,
                              out_step if out_step is not None
                              else self.global_step)
        return canvas

    def update_learning_rate(self, ratio: float):  # noqa: ARG002
        """No-op beyond reporting the rate: the schedule
        (``engine.make_lr_schedule``) already halves it every
        ``lr_decay_step`` epochs with the clip
        (``multimodal_classifier.py:267-277``)."""
        return self.engine.schedule(self.state.step)
