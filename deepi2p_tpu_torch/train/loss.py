"""Classification losses, counterpart of the JAX package's
``train/loss.py`` (reference ``models/focal_loss.py:55-112`` and
``models/multimodal_classifier.py:160-206``).

* Focal loss: softmax plus 1e-6 on the probabilities, the one-hot target
  plus 1e-6 on every class, weight ``(1 - p)^gamma``, ``alpha = 0.5,
  gamma = 2``, mean; both epsilons are the reference's.
* Fine CE over the inside-frustum points, as a fixed-shape mask:
  ``sum(mask * ce) / max(sum(mask), 1)``.

Over ranks that split the batch, ``psum`` sums a tensor over them (its
backward passes the gradient to the rank's own term): every mean and
ratio is then a ratio of summed numerators and denominators, the
single-process value on every rank, never a mean of per-rank means.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.projection import Labels

PSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _ratio(num: torch.Tensor, den: torch.Tensor, psum: PSum,
           floor: Optional[float] = None) -> torch.Tensor:
    """``num / den`` (``den`` clamped below at ``floor``), each summed over
    the ranks first when ``psum`` is given."""
    if psum is not None:
        num, den = psum(num), psum(den)
    return num / (den if floor is None else torch.clamp(den, min=floor))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, *,
               alpha: float = 0.5, gamma: float = 2.0, eps: float = 1e-6,
               class_weight: Optional[torch.Tensor] = None,
               psum: PSum = None) -> torch.Tensor:
    """Mean focal loss.  logits (..., C) f32, labels (...) int.

    ``class_weight`` (C,) weights each example by its true class (the
    JAX package's extension to push inside-frustum recall; the reference
    trains with none)."""
    p = torch.softmax(logits, dim=-1) + eps
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype) + eps
    focal = -alpha * ((1.0 - p) ** gamma) * torch.log(p)
    per_ex = torch.sum(onehot * focal, dim=-1)
    if class_weight is not None:
        w = torch.as_tensor(class_weight, dtype=per_ex.dtype,
                            device=per_ex.device)
        per_ex = per_ex * w[labels.long()]
    if psum is None:
        return torch.mean(per_ex)
    return _ratio(per_ex.sum(), per_ex.new_tensor(float(per_ex.numel())),
                  psum)


def masked_fine_ce(fine_logits: torch.Tensor, fine_labels: torch.Tensor,
                   inside_mask: torch.Tensor, psum: PSum = None
                   ) -> torch.Tensor:
    """Mean cross-entropy over the inside-frustum points only.

    fine_logits (B, N, L) f32; fine_labels (B, N) int in [0, L);
    inside_mask (B, N) {0, 1}."""
    logp = torch.log_softmax(fine_logits, dim=-1)
    ce = -torch.gather(logp, -1, fine_labels.long()[..., None])[..., 0]
    m = inside_mask.to(ce.dtype)
    if psum is None:
        return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)
    return _ratio(torch.sum(ce * m), torch.sum(m), psum, 1.0)


def classification_loss(coarse_logits: torch.Tensor,
                        fine_logits: Optional[torch.Tensor], labels: Labels,
                        *, coarse_loss_alpha: float,
                        inside_weight: float = 1.0, psum: PSum = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its metrics (reference
    ``multimodal_classifier.py:180-206``): ``loss``, ``coarse``, ``fine``,
    ``fine_accuracy``, ``coarse_accuracy``, ``inside_precision`` and
    ``inside_recall``.  ``fine_logits`` is None for a coarse-only model;
    ``inside_weight`` > 1 up-weights the inside class in the focal loss
    (1.0 is the reference's loss).  The metrics are detached."""
    cw = (None if inside_weight == 1.0
          else torch.tensor([1.0, float(inside_weight)]))
    coarse = focal_loss(coarse_logits, labels.coarse, class_weight=cw,
                        psum=psum) * coarse_loss_alpha
    metrics: Dict[str, torch.Tensor] = {}
    if fine_logits is not None:
        fine = masked_fine_ce(fine_logits, labels.fine, labels.coarse, psum)
        loss = coarse + fine
        fine_pred = torch.argmax(fine_logits, dim=-1)
        m = labels.coarse.float()
        fine_acc = _ratio(torch.sum((fine_pred == labels.fine).float() * m),
                          torch.sum(m), psum, 1.0)
        metrics.update(fine=fine, fine_accuracy=fine_acc)
    else:
        loss = coarse
    coarse_pred = torch.argmax(coarse_logits, dim=-1)
    tp = torch.sum(((coarse_pred == 1) & (labels.coarse == 1)).float())
    pp = torch.sum((coarse_pred == 1).float())
    ap = torch.sum((labels.coarse == 1).float())
    hits = (coarse_pred == labels.coarse).float()
    metrics.update(
        loss=loss, coarse=coarse,
        coarse_accuracy=(torch.mean(hits) if psum is None else _ratio(
            hits.sum(), hits.new_tensor(float(hits.numel())), psum)),
        inside_precision=_ratio(tp, pp, psum, 1.0),
        inside_recall=_ratio(tp, ap, psum, 1.0))
    return loss, {k: v.detach() for k, v in metrics.items()}
