"""Monocular depth estimator of the ICP pipeline, counterpart of the JAX
package's ``models/depth.py``.

The reference's ICP evaluation starts from an external monodepth2 model
(``evaluation/icp/save_depth_map.py:60-102``); the in-repo stand-in is a
small conv encoder-decoder trained on the synthetic renderer's depth: four
levels of two 3x3 conv blocks (conv, GroupNorm, ReLU), the first of each
level after the first with stride 2; a decoder that resizes to the skip's
size by nearest neighbour, concatenates the skip and applies one block;
a 3x3 head whose sigmoid spans log-depth [-0.7, 4.5] (~0.5 m to ~90 m).

NCHW inside; the input is (B, H, W, 3) in [0, 255] and the output (B, H,
W) metres, as in JAX.  Three details make it flax's function:

* ``padding="SAME"`` pads ``(k - 1) - (n - 1) % s`` in total, the smaller
  half before: a stride-2 conv of an even size pads (0, 1), not (1, 1)
  (:func:`same_pad`);
* ``jax.image.resize(method="nearest")`` is torch's ``nearest-exact``
  (the source index ``floor((i + 0.5) * in / out)``), not ``nearest``;
* flax's ``GroupNorm`` takes ``min(8, C)`` groups, epsilon 1e-6 and the
  variance as ``max(0, E[x^2] - E[x]^2)``, in f32 whatever the compute
  dtype (:class:`GroupNorm`).

Module names follow flax's (``enc{i}``, ``enc{i}b``, ``dec{i}``,
``head``; ``.conv`` for ``Conv_0``, ``.norm`` for ``GroupNorm_0``), and
:func:`~.from_jax.depth_state_dict_from_flax` carries flax weights over.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dtypes import widen

WIDTHS = (16, 32, 64, 128)
MIN_LOG = -0.7     # ~0.5 m
MAX_LOG = 4.5      # ~90 m
GN_EPS = 1e-6      # flax's GroupNorm epsilon
LOG_FLOOR = 1e-3   # depth_loss clamps both maps here before the log


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad (B, C, H, W) as XLA's ``SAME`` does for a k x k conv."""
    pads = []
    for n in (x.shape[3], x.shape[2]):       # F.pad: last axis first
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class GroupNorm(nn.Module):
    """flax's ``GroupNorm`` on NCHW maps: ``min(8, C)`` groups, statistics
    over (C/G, H, W) per sample and group in f32 (f64 in a float64 copy),
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in that
    precision, returned in ``x``'s dtype."""

    def __init__(self, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.groups, self.eps = min(8, channels), eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        G = self.groups
        # contiguous first: a channels-last map (the CPU's convolutions
        # return one) is reduced along strides in one long running sum,
        # ~1e-4 off where E[x^2] - E[x]^2 cancels
        xf = widen(x).contiguous().reshape(B, G, C // G, H * W)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(2, 3), keepdim=True)
                          - mean * mean, min=0.0)
        shape = (1, G, C // G, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(shape)
        y = (xf - mean) * mul + self.bias.reshape(shape)
        return y.reshape(B, C, H, W).to(x.dtype)


class ConvBlock(nn.Module):
    """3x3 conv (no bias, SAME padding) -> GroupNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, bias=False)
        self.norm = GroupNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(same_pad(x, 3, self.stride),
                     self.conv.weight.to(x.dtype), stride=self.stride)
        return F.relu(self.norm(x))


class DepthNet(nn.Module):
    """img (B, H, W, 3) in [0, 255] -> depth (B, H, W) metres.

    ``compute_dtype`` (``"float32"``, ``"bfloat16"`` or ``"float64"``) is
    the dtype of the convolutions' inputs and weights, as flax's
    ``dtype``; parameters stay in their own dtype and the normalisation
    statistics and the output head's sigmoid run in f32 (f64 for a
    float64 copy)."""

    def __init__(self, widths: Sequence[int] = WIDTHS,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.widths = tuple(widths)
        self.dtype = getattr(torch, compute_dtype)
        cin = 3
        for i, w in enumerate(self.widths):
            setattr(self, f"enc{i}", ConvBlock(cin, w, 1 if i == 0 else 2))
            setattr(self, f"enc{i}b", ConvBlock(w, w))
            cin = w
        for i in reversed(range(len(self.widths) - 1)):
            setattr(self, f"dec{i}", ConvBlock(cin + self.widths[i],
                                               self.widths[i]))
            cin = self.widths[i]
        self.head = nn.Conv2d(cin, 1, 3)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2).to(self.dtype) / 255.0 - 0.5
        skips = []
        for i in range(len(self.widths)):
            x = getattr(self, f"enc{i}b")(getattr(self, f"enc{i}")(x))
            skips.append(x)
        for i in reversed(range(len(self.widths) - 1)):
            s = skips[i]
            x = F.interpolate(x, size=s.shape[2:], mode="nearest-exact")
            x = getattr(self, f"dec{i}")(torch.cat([x, s], dim=1))
        out = F.conv2d(same_pad(x, 3, 1), self.head.weight.to(x.dtype),
                       self.head.bias.to(x.dtype))[:, 0]
        log_d = MIN_LOG + (MAX_LOG - MIN_LOG) * torch.sigmoid(widen(out))
        return torch.exp(log_d)


def depth_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Masked log-L1 over the pixels with a target (gt > 0)."""
    mask = (gt > 0).to(pred.dtype)
    err = torch.abs(torch.log(torch.clamp(pred, min=LOG_FLOOR))
                    - torch.log(torch.clamp(gt.to(pred.dtype),
                                            min=LOG_FLOOR)))
    return torch.sum(err * mask) / torch.clamp(torch.sum(mask), min=1.0)


def init_depth_params_(model: DepthNet,
                       generator: Optional[torch.Generator] = None) -> None:
    """Seeded initialisation with flax's defaults: convolution kernels
    LeCun normal (truncated at two standard deviations, fan in), the
    head's bias zero, GroupNorm scale one and bias zero."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                # flax's truncated_normal: the std of the truncated
                # distribution is 1 / sqrt(fan_in)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def build_depth_net(compute_dtype: str = "float32", seed: int = 0,
                    device="cpu") -> DepthNet:
    """A seeded :class:`DepthNet` (drawn on the CPU, then moved)."""
    model = DepthNet(compute_dtype=compute_dtype)
    init_depth_params_(model, torch.Generator().manual_seed(seed))
    return model.to(device)
