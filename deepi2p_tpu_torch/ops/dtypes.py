"""The precision the port takes sums and statistics in."""
from __future__ import annotations

import torch


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is when it is f64: bf16 and f32 forwards
    take their statistics and sums in f32, as the JAX package does, and a
    float64 copy of the model (``compute_dtype="float64"``, its weights
    in f64), which gradient checks hold f32 runs against, stays f64."""
    return x if x.dtype == torch.float64 else x.float()
