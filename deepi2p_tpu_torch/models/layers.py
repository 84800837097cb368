"""PointNet building blocks, channel-last, counterpart of the JAX
package's ``models/layers.py``.

Every reference PointNet variant is a stack of kernel-size-1 layers over a
trailing channel axis: here ``nn.Linear`` on inputs of any shape
``(..., C)``.  Module names follow the reference's state_dict
(``layers.{i}.conv`` / ``layers.{i}.norm``), which is also what the JAX
package's ``export_torch_detector`` writes.

Dtype policy (the JAX package's, ``config.compute_dtype``): a layer casts
its input, weight and bias to the compute dtype; normalisation computes in
f32 (f64 in a float64 copy of the model, ``ops.dtypes.widen``) and returns
the compute dtype.  Parameters stay f32.

Train mode (``module.train()``) follows flax: batch norm normalises with
the batch's statistics and updates its running ones, and dropout draws
its mask from the ``torch.Generator`` the caller passes to the forward.
In eval mode batch norm uses the running statistics and dropout is off.

Over several ranks (``parallel/mesh.py::shard_state`` sets these; a
single process leaves them ``None``): ``Norm.reduce`` sums a batch norm's
per-channel sums over the ranks of the batch, ``PNLayer.batch_rows``
makes dropout draw the whole batch's mask and keep the rank's rows, and
``PNLayer.tp`` computes a Linear whose output channels are split over
ranks and gathers them.

On the card ``Norm`` runs one hand-written kernel pair, forward and
backward, with the ReLU that follows it where there is one
(``ops/norm_cuda.py``); on the CPU its tensor code, :meth:`Norm.plain`.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dtypes import widen
from ..ops.norm_cuda import norm_cuda

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "elu": F.elu,
    "swish": F.silu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "selu": F.selu,
}


class Norm(nn.Module):
    """Batch or instance normalisation over all but the channel axis.

    ``kind="batch"`` is flax's ``BatchNorm``: in eval mode it normalises
    with the running statistics; in train mode with the batch's, taken in
    f32 over every axis but the channel axis, the variance the biased
    ``max(0, mean(x^2) - mean(x)^2)`` (gradients flow through both), and
    it updates the running ones as ``decay * running + (1 - decay) *
    batch``, the running variance the biased one too (``torch.nn``'s
    batch norm keeps the unbiased one).  ``momentum`` is the torch
    convention, the weight of the batch (``decay = 1 - momentum``, flax's
    ``momentum``).  ``kind="instance"`` normalises each sample over its
    non-channel axes (flax ``GroupNorm`` with one channel per group) in
    both modes.  ``channel_axis`` is -1 for point features, 1 for NCHW
    maps.
    """

    def __init__(self, channels: int, kind: str = "batch", eps: float = 1e-5,
                 channel_axis: int = -1, momentum: float = 0.1):
        super().__init__()
        if kind not in ("batch", "instance"):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind, self.eps, self.channel_axis = kind, eps, channel_axis
        self.decay = 1.0 - momentum
        # (sum, sum of squares, count) -> the same summed over the ranks
        # that split the batch
        self.reduce = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if kind == "batch":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """The norm of ``x``, then a ReLU where ``relu``: on a CUDA tensor
        the kernels of ``ops/norm_cuda.py`` around PyTorch's two
        reductions (:meth:`moments`), else :meth:`plain`."""
        if x.is_cuda:
            return norm_cuda(self, x, relu)
        y = self.plain(x)
        return F.relu(y) if relu else y

    def moments(self, xf: torch.Tensor, xsq: torch.Tensor | None = None):
        """The batch's ``(mean, E[x^2])`` of ``xf`` (the input in the
        precision of its statistics, ``ops.dtypes.widen``), over every
        axis but the channels (and the first, for instance norm), shaped
        to broadcast against it; under ``reduce`` over the ranks too.
        ``xsq`` is ``xf * xf`` where the caller has it; else it is formed
        after the first reduction, the order autograd's sums of ``xf``'s
        gradient follow."""
        ch = self.channel_axis % xf.dim()
        first = 0 if self.kind == "batch" else 1
        axes = [a for a in range(first, xf.dim()) if a != ch]
        if self.kind == "batch" and self.reduce is not None:
            s = xf.sum(dim=axes, keepdim=True)
            sq = xf * xf if xsq is None else xsq
            s, ss, n = self.reduce(s, sq.sum(dim=axes, keepdim=True),
                                   xf.numel() // xf.shape[ch])
            return s / n, ss / n
        mean = xf.mean(dim=axes, keepdim=True)
        sq = xf * xf if xsq is None else xsq
        return mean, sq.mean(dim=axes, keepdim=True)

    def statistics(self, xf: torch.Tensor):
        """``(mean, var, clamped)`` that normalise ``xf`` (not read in
        eval mode), shaped to broadcast against it: in eval mode the
        running ones and ``clamped`` None; else the batch's
        (:meth:`moments`), ``clamped`` where ``E[x^2] - mean^2`` was below
        0 (the variance is clamped to 0 there), and the running ones
        updated."""
        if self.kind == "batch" and not self.training:
            shape = [1] * xf.dim()
            shape[self.channel_axis] = -1
            return (self.running_mean.reshape(shape),
                    self.running_var.reshape(shape), None)
        mean, ex2 = self.moments(xf)
        raw = ex2 - mean * mean
        var = torch.clamp(raw, min=0.0)
        if self.kind == "batch":
            with torch.no_grad():
                d = self.decay
                self.running_mean.copy_(d * self.running_mean
                                        + (1.0 - d) * mean.reshape(-1))
                self.running_var.copy_(d * self.running_var
                                       + (1.0 - d) * var.reshape(-1))
        return mean, var, raw < 0

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The norm as tensor code: the CPU's path, and the plain version
        the kernel is held to."""
        xf = widen(x)
        mean, var, _ = self.statistics(xf)
        shape = [1] * x.dim()
        shape[self.channel_axis] = -1
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(shape)
        y = (xf - mean) * mul + self.bias.reshape(shape)
        return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """flax's ``Dropout`` in train mode: keep where a uniform draw is below
    ``1 - rate`` (``random.bernoulli``), scale the kept values by
    ``1 / (1 - rate)`` in ``x``'s dtype, zero the rest.  The uniforms are
    drawn on ``generator``'s device and moved to ``x``'s, so one seed of a
    CPU generator gives one mask on every device.  ``rows = (r, n)``: ``x``
    is part ``r`` of ``n`` equal row blocks of a batch; the mask of the
    whole batch is drawn and the part's rows kept."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(pass generator= to the forward)")
    keep_prob = 1.0 - rate
    if rows is None:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
    else:
        r, n = rows
        b = x.shape[0]
        u = torch.rand((n * b, *x.shape[1:]), generator=generator,
                       device=generator.device)[r * b:(r + 1) * b]
    keep = (u < keep_prob).to(x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class PNLayer(nn.Module):
    """Linear -> [Norm -> activation] -> [dropout] on the last axis."""

    def __init__(self, in_ch: int, out_ch: int, *, norm_act: bool,
                 normalization: str, activation: str, dtype: torch.dtype,
                 norm_momentum: float = 0.1, dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Linear(in_ch, out_ch)
        self.norm = (Norm(out_ch, normalization, momentum=norm_momentum)
                     if norm_act else None)
        self.act = ACTIVATIONS[activation] if norm_act else None
        # a ReLU runs inside the norm's kernel
        self.fuse_relu = activation == "relu"
        self.dtype = dtype
        self.dropout_rate = dropout
        # the rank's block of the batch, (r, n), for dropout
        self.batch_rows = None
        # a split Linear: .enter(x) before it, .gather(y) after it
        self.tp = None

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if self.tp is not None:
            x = self.tp.enter(x)
        x = F.linear(x, self.conv.weight.to(dt), self.conv.bias.to(dt))
        if self.tp is not None:
            x = self.tp.gather(x)
        if self.norm is not None:
            x = (self.norm(x, relu=True) if self.fuse_relu
                 else self.act(self.norm(x)))
        if self.training and 0.0 < self.dropout_rate < 1.0:
            x = dropout(x, self.dropout_rate, generator, self.batch_rows)
        return x


def make_layers(in_ch: int, features: Sequence[int], *,
                normalization: str = "batch", activation: str = "relu",
                norm_act_at_last: bool = False, norm_momentum: float = 0.1,
                dropout_list: Sequence[float] | None = None,
                dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    drops = dropout_list or [0.0] * len(features)
    layers = []
    for i, c in enumerate(features):
        last = i == len(features) - 1
        layers.append(PNLayer(in_ch, c, norm_act=(not last) or norm_act_at_last,
                              normalization=normalization,
                              activation=activation, dtype=dtype,
                              norm_momentum=norm_momentum, dropout=drops[i]))
        in_ch = c
    return nn.ModuleList(layers)


def run_layers(layers: nn.ModuleList, x: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
    for layer in layers:
        x = layer(x, generator)
    return x


class PointNetMLP(nn.Module):
    """A stack of shared-point layers (reference ``PointNet``)."""

    def __init__(self, in_ch: int, features: Sequence[int], **kw):
        super().__init__()
        self.layers = make_layers(in_ch, features, **kw)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return run_layers(self.layers, x, generator)


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
