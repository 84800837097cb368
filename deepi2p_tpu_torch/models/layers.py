"""PointNet building blocks, channel-last, counterpart of the JAX
package's ``models/layers.py``.

Every reference PointNet variant is a stack of kernel-size-1 layers over a
trailing channel axis: here ``nn.Linear`` on inputs of any shape
``(..., C)``.  Module names follow the reference's state_dict
(``layers.{i}.conv`` / ``layers.{i}.norm``), which is also what the JAX
package's ``export_torch_detector`` writes.

Dtype policy (the JAX package's, ``config.compute_dtype``): a layer casts
its input, weight and bias to the compute dtype; normalisation computes in
f32 and returns the compute dtype.  Parameters stay f32.

This slice is inference only: batch norm uses its running statistics and
dropout is off.  Training (batch statistics, dropout) comes with the
training slice.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "elu": F.elu,
    "swish": F.silu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "selu": F.selu,
}


class Norm(nn.Module):
    """Batch or instance normalisation over all but the channel axis.

    ``kind="batch"`` normalises with the running statistics (flax
    convention: the running variance is the biased one).
    ``kind="instance"`` normalises each sample over its non-channel axes
    (flax ``GroupNorm`` with one channel per group).  ``channel_axis`` is
    -1 for point features, 1 for NCHW maps.
    """

    def __init__(self, channels: int, kind: str = "batch", eps: float = 1e-5,
                 channel_axis: int = -1):
        super().__init__()
        if kind not in ("batch", "instance"):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind, self.eps, self.channel_axis = kind, eps, channel_axis
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if kind == "batch":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = [1] * x.dim()
        shape[self.channel_axis] = -1
        if self.kind == "batch":
            mean = self.running_mean.reshape(shape)
            var = self.running_var.reshape(shape)
        else:
            ch = self.channel_axis % x.dim()
            axes = [a for a in range(1, x.dim()) if a != ch]
            mean = xf.mean(dim=axes, keepdim=True)
            var = torch.clamp((xf * xf).mean(dim=axes, keepdim=True)
                              - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(shape)
        y = (xf - mean) * mul + self.bias.reshape(shape)
        return y.to(x.dtype)


class PNLayer(nn.Module):
    """Linear -> [Norm -> activation] on the last axis."""

    def __init__(self, in_ch: int, out_ch: int, *, norm_act: bool,
                 normalization: str, activation: str, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Linear(in_ch, out_ch)
        self.norm = Norm(out_ch, normalization) if norm_act else None
        self.act = ACTIVATIONS[activation] if norm_act else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.linear(x.to(dt), self.conv.weight.to(dt),
                     self.conv.bias.to(dt))
        if self.norm is not None:
            x = self.act(self.norm(x))
        return x


def make_layers(in_ch: int, features: Sequence[int], *,
                normalization: str = "batch", activation: str = "relu",
                norm_act_at_last: bool = False,
                dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    layers = []
    for i, c in enumerate(features):
        last = i == len(features) - 1
        layers.append(PNLayer(in_ch, c, norm_act=(not last) or norm_act_at_last,
                              normalization=normalization,
                              activation=activation, dtype=dtype))
        in_ch = c
    return nn.ModuleList(layers)


def run_layers(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = layer(x)
    return x


class PointNetMLP(nn.Module):
    """A stack of shared-point layers (reference ``PointNet``)."""

    def __init__(self, in_ch: int, features: Sequence[int], **kw):
        super().__init__()
        self.layers = make_layers(in_ch, features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_layers(self.layers, x)


def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's initialisers: He normal
    (fan in) for Linear, Kaiming normal (fan out) for convolutions, zero
    bias, unit norm scale, identity running statistics."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, math.sqrt(2.0 / m.in_features),
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            elif isinstance(m, Norm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if m.kind == "batch":
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
