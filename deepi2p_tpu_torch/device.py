"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default.  The CPU is used only when
the caller names it (the tests do); a CUDA request on a machine without a
card raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev
