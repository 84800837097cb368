"""Training and inference engine, counterpart of the JAX package's
``train/engine.py::Engine``.

The JAX engine's state is a pytree (step, params, batch_stats, Adam
state) and its steps are pure functions; here a :class:`TrainState` holds
the ``KeypointDetector`` (parameters and batch-norm statistics), the Adam
moments and the step, on the engine's device, and :meth:`Engine.train_step`
updates it in place and returns it.  One step:

1. labels by ``ops.projection.generate_labels`` on the device;
2. the forward in train mode (batch statistics; the head's dropout draws
   from the caller's ``torch.Generator``);
3. the loss (``train.loss.classification_loss``);
4. the backward;
5. Adam (0.9, 0.999, eps 1e-8, no weight decay) in optax's order of
   operations, at the learning rate of the step before the increment
   (:func:`make_lr_schedule`, read as optax reads a schedule);
6. the batch-norm running statistics (updated by the forward itself);
7. ``metrics["lr"]`` and ``metrics["fine_violations"]``.

:meth:`Engine.train_step_scan` takes K steps in one call over a stacked
``(K, B, ...)`` batch (the JAX ``lax.scan`` of ``--steps-per-dispatch``):
a Python loop of the same step on the views ``batches[k]``, drawing from
one generator in sequence, so a call is K :meth:`~Engine.train_step`
calls on the same generator.

``infer``, ``infer_probs`` and ``infer_probs_fine`` take a
:class:`TrainState` or a bare ``KeypointDetector``, move the batch's
inputs (numpy arrays or tensors) to the device, run the forward in eval
mode and return tensors there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Union

import torch

from ..config import Config
from ..device import resolve_device
from ..models.detector import INPUT_KEYS, KeypointDetector, build_detector
from ..ops.projection import generate_labels
from ..utils.profiling import span
from .loss import classification_loss

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """The model, Adam's first and second moments (one f32 tensor per
    parameter, in ``model.named_parameters()`` order) and the step."""
    model: KeypointDetector
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int = 0

    def reset_optimizer(self) -> None:
        """Fresh (zero) Adam moments, as ``tx.init`` gives."""
        self.mu = [torch.zeros_like(p) for p in self.model.parameters()]
        self.nu = [torch.zeros_like(p) for p in self.model.parameters()]


def model_of(state: Union[TrainState, KeypointDetector]) -> KeypointDetector:
    """The detector of a :class:`TrainState`, or the detector itself."""
    return state.model if isinstance(state, TrainState) else state


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """``lr * decay^(epoch // decay_step)``, clipped below at
    ``cfg.lr_clip``; a step -> learning rate (f32-rounded)."""
    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        lr = cfg.lr * cfg.lr_decay_scale ** (epoch // cfg.lr_decay_step)
        return float(torch.tensor(max(lr, cfg.lr_clip), dtype=torch.float32))
    return schedule


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                mu: List[torch.Tensor], nu: List[torch.Tensor], count: int,
                lr: float) -> None:
    """One optax ``adam`` step in place, in optax's order of operations:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
    correction with ``1 - b^(count+1)`` in f32, ``u = mu_hat /
    (sqrt(nu_hat) + eps)``, ``p += (-lr) u``.  ``count`` is the number of
    steps taken before this one."""
    with torch.no_grad():
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - ADAM_B2)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, sq)
        n = torch.tensor(count + 1, dtype=torch.float32)
        f32 = dict(dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(ADAM_B1, **f32) ** n)
        bc2 = float(1.0 - torch.tensor(ADAM_B2, **f32) ** n)
        mu_hat = torch._foreach_div(mu, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


class Engine:
    """The detector's definition, optimiser and steps on one device."""

    # the sum of a tensor over the ranks that split the batch (the loss's
    # numerators and denominators); None on one process
    _psum = None

    def __init__(self, cfg: Config, steps_per_epoch: int = 1000,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """Seeded weights (``models.detector.build_detector``), zero Adam
        moments, step 0, on the engine's device."""
        state = TrainState(build_detector(self.cfg, device=self.device,
                                          seed=seed), [], [])
        state.reset_optimizer()
        return state

    # -- forward helpers -----------------------------------------------------
    def _inputs(self, batch: Dict):
        return [torch.as_tensor(batch[k], device=self.device)
                for k in INPUT_KEYS]

    def _labels(self, batch: Dict):
        cfg = self.cfg
        pc, P, K = (torch.as_tensor(batch[k], device=self.device)
                    for k in ("pc", "P", "K"))
        return generate_labels(pc, P, K, cfg.img_H, cfg.img_W,
                               cfg.img_fine_resolution_scale)

    def _loss(self, out, batch: Dict):
        cfg = self.cfg
        labels = self._labels(batch)
        coarse, fine = out if cfg.is_fine_resolution else (out, None)
        psum = self._psum
        loss, metrics = classification_loss(
            coarse, fine, labels, coarse_loss_alpha=cfg.coarse_loss_alpha,
            inside_weight=cfg.coarse_inside_weight, psum=psum)
        # the reference asserts this is zero (multimodal_classifier.py:169)
        v = labels.fine_violations
        metrics["fine_violations"] = v if psum is None else psum(v)
        return loss, metrics

    # -- steps ---------------------------------------------------------------
    def loss_and_grads(self, state: TrainState, batch: Dict,
                       generator: torch.Generator):
        """Steps 1-4 and 6 of a train step: (loss, metrics, gradients in
        ``model.parameters()`` order).  The forward updates the running
        statistics; the parameters and moments are left as they were."""
        model = state.model.train()
        with span("train.forward"):
            out = model(*self._inputs(batch), generator=generator)
        with span("train.loss"):
            loss, metrics = self._loss(out, batch)
        params = list(model.parameters())
        with span("train.backward"):
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), metrics, list(grads)

    def apply_gradients(self, state: TrainState,
                        grads: List[torch.Tensor]) -> float:
        """Step 5: one Adam update at the schedule's rate for
        ``state.step``, then ``state.step += 1``; returns that rate."""
        lr = self.schedule(state.step)
        adam_update(list(state.model.parameters()), grads, state.mu,
                    state.nu, state.step, lr)
        state.step += 1
        return lr

    def _step(self, state: TrainState, batch: Dict,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("train.step", step=state.step):
            _, metrics, grads = self.loss_and_grads(state, batch, generator)
            with span("train.adam"):
                lr = self.apply_gradients(state, grads)
            metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return metrics

    def train_step(self, state: TrainState, batch: Dict,
                   generator: torch.Generator):
        """One training step (module docstring); returns ``(state,
        metrics)``, the metrics detached tensors on the device."""
        metrics = self._step(state, batch, generator)
        if self.cfg.is_debug:  # loss-dict echo (multimodal_classifier.py:209)
            print({k: float(v) for k, v in metrics.items()})
        return state, metrics

    def train_step_scan(self, state: TrainState, batches: Dict,
                        generator: torch.Generator):
        """K training steps in one call; every value of ``batches`` is
        (K, B, ...), and trip k trains on the views ``batches[key][k]``.
        Returns ``(state, metrics)``: the last trip's metrics, with its
        learning rate; ``state.step`` grows by K."""
        K = len(next(iter(batches.values())))
        for k in range(K):
            metrics = self._step(state, {key: v[k] for key, v in
                                         batches.items()}, generator)
        return state, metrics

    @torch.no_grad()
    def _forward(self, state, batch: Dict):
        return model_of(state).eval()(*self._inputs(batch))

    def eval_step(self, state, batch: Dict) -> Dict[str, torch.Tensor]:
        """The loss metrics of the eval-mode forward (no update)."""
        out = self._forward(state, batch)
        _, metrics = self._loss(out, batch)
        return metrics

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
