"""The reference's wider layer library, channel-last, counterpart of the
JAX package's ``models/extra_layers.py``.  The detector uses none of them;
they are here for users of the library:

* :class:`EMAU` -- Expectation-Maximization Attention Unit
  (``models/layers_common.py:11-89``);
* :class:`PointResNet` -- PointNet with a skip connection
  (``models/layers_pc.py:459-510``);
* :class:`PointNetFusion` -- PointNet with global-max-pool fusion
  (``models/layers_pc.py:513-587``; on (B, M, K, C) inputs the Conv2d
  variant);
* :class:`UpConv` -- bilinear upsample + 3x3 conv
  (``models/layers_pc.py:193-256``);
* :class:`KNNModule` / :class:`KNNFusionModule` -- self-kNN aggregation
  over node coordinates (``models/layers_pc.py:687-753,821-896``); the
  neighbours come from the port's ``knn``, so on the card from the kNN
  kernel;
* :class:`ConvModule`, :class:`WSConv`, :class:`Scale` -- mmcv's
  ``ConvModule``, ``ConvWS2d`` and ``Scale``.

Every module is an ``nn.Module`` with train and eval modes (batch norm as
:class:`~.layers.Norm`: batch statistics and running updates in train
mode).  Images are NHWC, as in the JAX package.  Submodule and parameter
names follow the flax ones, so
:func:`~.from_jax.extra_state_dict_from_flax` carries a flax module's
variables over.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.knn import gather_knn, knn
from .layers import ACTIVATIONS, Norm, PointNetMLP


def _norm(kind: Optional[str], channels: int) -> Optional[nn.Module]:
    """``NormLayer``: batch or instance norm over all but the last axis;
    None or ``"none"`` is no layer."""
    if kind in (None, "none"):
        return None
    return Norm(channels, kind, momentum=0.1)


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias, stride,
               padding) -> torch.Tensor:
    """A convolution of an NHWC input with an OIHW weight; ``padding`` an
    int, ``"SAME"`` or ``"VALID"`` (flax's conventions)."""
    xc = x.permute(0, 3, 1, 2)
    kh, kw = weight.shape[2:]
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    if isinstance(padding, int):
        pads = (padding, padding, padding, padding)
    elif padding == "VALID":
        pads = (0, 0, 0, 0)
    elif padding == "SAME":
        def split(size, k, s):
            total = max((math.ceil(size / s) - 1) * s + k - size, 0)
            return total // 2, total - total // 2
        top, bottom = split(xc.shape[2], kh, sh)
        left, right = split(xc.shape[3], kw, sw)
        pads = (left, right, top, bottom)
    else:
        raise ValueError(f"padding {padding!r}: an int, 'SAME' or 'VALID'")
    y = F.conv2d(F.pad(xc, pads), weight, bias, stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


class EMAU(nn.Module):
    """Expectation-Maximization attention over a point axis: (B, N, C) ->
    (out (B, N, C), mu (B, K, C)).  The EM iterations see the features
    without gradient, as the reference's ``torch.no_grad`` block
    (``layers_common.py:56-63``)."""

    def __init__(self, channels: int, bases: int, stage_num: int = 1,
                 is_normalized: bool = False):
        super().__init__()
        self.stage_num, self.is_normalized = stage_num, is_normalized
        self.mu = nn.Parameter(torch.randn(1, bases, channels)
                               * math.sqrt(2.0 / bases))
        self.conv1 = nn.Linear(channels, channels)
        self.conv2 = nn.Linear(channels, channels, bias=False)
        self.conv2_bn = Norm(channels, "batch", momentum=0.1)

    def _l2norm(self, x, dim):
        if self.is_normalized:
            return x / (1e-6 + torch.linalg.vector_norm(x, dim=dim,
                                                        keepdim=True))
        return x

    def forward(self, x: torch.Tensor):
        B = x.shape[0]
        idn = x
        x = self.conv1(x)
        mu = self.mu.expand(B, -1, -1)
        xs = x.detach()
        z = None
        for _ in range(self.stage_num):
            z = torch.softmax(torch.einsum("bnc,bkc->bnk", xs, mu), dim=2)
            z_norm = z / (1e-6 + z.sum(dim=1, keepdim=True))
            mu = self._l2norm(torch.einsum("bnk,bnc->bkc", z_norm, xs), 2)
        x = F.relu(torch.einsum("bnk,bkc->bnc", z, mu))
        x = self.conv2_bn(self.conv2(x))
        return x + idn, mu


def _mlp(in_ch, features, normalization, norm_momentum, activation,
         norm_act_at_last):
    return PointNetMLP(in_ch, features, normalization=normalization,
                       norm_momentum=norm_momentum, activation=activation,
                       norm_act_at_last=norm_act_at_last)


class PointResNet(nn.Module):
    """PointNet layers ``layer_0 .. layer_{L-1}`` whose last consumes
    cat(first output, last hidden) (``models/layers_pc.py:492-510``)."""

    def __init__(self, in_ch: int, features: Sequence[int],
                 normalization: str = "batch", norm_momentum: float = 0.1,
                 activation: str = "relu"):
        super().__init__()
        feats = list(features)
        kw = dict(normalization=normalization, norm_momentum=norm_momentum,
                  activation=activation, norm_act_at_last=True)
        self.n = len(feats)
        chans = [in_ch] + feats[:-2]
        for i, c in enumerate(feats[:-1]):
            setattr(self, f"layer_{i}", _mlp(chans[i], [c], **kw))
        hidden = feats[-2] if len(feats) > 2 else feats[0]
        setattr(self, f"layer_{self.n - 1}",
                _mlp(feats[0] + hidden, [feats[-1]], **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out0 = self.layer_0(x)
        h = out0
        for i in range(1, self.n - 1):
            h = getattr(self, f"layer_{i}")(h)
        return getattr(self, f"layer_{self.n - 1}")(
            torch.cat([out0, h], dim=-1))


class PointNetFusion(nn.Module):
    """Two PointNets fused by a broadcast global max-pool over
    ``pool_axis`` (``models/layers_pc.py:513-587``); ``final_pool``
    returns the pooled max (the Conv2d variant)."""

    def __init__(self, in_ch: int, features_before: Sequence[int],
                 features_after: Sequence[int],
                 normalization: str = "batch", norm_momentum: float = 0.1,
                 activation: str = "relu",
                 act_norm_at_end_of_pn1: bool = True, pool_axis: int = -2,
                 final_pool: bool = False):
        super().__init__()
        kw = dict(normalization=normalization, norm_momentum=norm_momentum,
                  activation=activation)
        self.pool_axis, self.final_pool = pool_axis, final_pool
        self.before = _mlp(in_ch, features_before,
                           norm_act_at_last=act_norm_at_end_of_pn1, **kw)
        self.after = _mlp(2 * features_before[-1], features_after,
                          norm_act_at_last=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.before(x)
        pooled = torch.amax(x, dim=self.pool_axis, keepdim=True)
        y = self.after(torch.cat([x, pooled.expand_as(x)], dim=-1))
        if self.final_pool:
            return torch.amax(y, dim=self.pool_axis)
        return y


class UpConv(nn.Module):
    """Bilinear upsample by ``scale`` (half-pixel centres) + 3x3 conv, then
    optional norm and activation; NHWC (``models/layers_pc.py:193-256``)."""

    def __init__(self, in_ch: int, features: int, scale: int = 2,
                 normalization: Optional[str] = None,
                 activation: Optional[str] = None):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(in_ch, features, 3)
        self.norm = _norm(normalization, features)
        self.act = ACTIVATIONS[activation] if activation else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=self.scale,
                          mode="bilinear", align_corners=False)
        x = _conv_nhwc(x.permute(0, 2, 3, 1), self.conv.weight,
                       self.conv.bias, 1, 1)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x) if self.act else x


def _neighbourhood(coords: torch.Tensor, features: torch.Tensor, k: int,
                   center_type: str):
    """(center (B, M, 1, 3), cat(decentred coords, neighbour features)
    (B, M, k, 3 + C)) over each node's k nearest nodes."""
    _, idx = knn(coords.detach(), coords.detach(), k)
    nb = gather_knn(coords, idx)
    if center_type == "avg":
        center = nb.mean(dim=2, keepdim=True)
    else:
        center = coords[:, :, None, :]
    decentered = (nb - center).detach()
    return center, torch.cat([decentered, gather_knn(features, idx)], -1)


class KNNModule(nn.Module):
    """Per node: its k nearest nodes decentred, a shared MLP, a max-pool
    (``models/layers_pc.py:687-753``).  (coords (B, M, 3), features
    (B, M, C)) -> (centers (B, M, 3), out (B, M, C'))."""

    def __init__(self, in_ch: int, features: Sequence[int], k: int,
                 center_type: str = "center", normalization: str = "batch",
                 norm_momentum: float = 0.1, activation: str = "relu"):
        super().__init__()
        self.k, self.center_type = k, center_type
        self.mlp = _mlp(3 + in_ch, features, normalization, norm_momentum,
                        activation, True)

    def forward(self, coords, features) -> Tuple[torch.Tensor, torch.Tensor]:
        center, y = _neighbourhood(coords, features, self.k,
                                   self.center_type)
        return center[:, :, 0, :].detach(), torch.amax(self.mlp(y), dim=2)


class KNNFusionModule(nn.Module):
    """:class:`KNNModule` with a two-stage max-pool fusion
    (``models/layers_pc.py:821-896``): the pooled neighbourhood feature is
    broadcast back and concatenated before a second MLP."""

    def __init__(self, in_ch: int, features_before: Sequence[int],
                 features_after: Sequence[int], k: int,
                 center_type: str = "center", normalization: str = "batch",
                 norm_momentum: float = 0.1, activation: str = "relu"):
        super().__init__()
        self.k, self.center_type = k, center_type
        kw = (normalization, norm_momentum, activation, True)
        self.before = _mlp(3 + in_ch, features_before, *kw)
        self.after = _mlp(2 * features_before[-1], features_after, *kw)

    def forward(self, coords, features) -> Tuple[torch.Tensor, torch.Tensor]:
        center, y = _neighbourhood(coords, features, self.k,
                                   self.center_type)
        y = self.before(y)
        pooled = torch.amax(y, dim=2, keepdim=True)
        y = self.after(torch.cat([pooled.expand_as(y), y], dim=-1))
        return center[:, :, 0, :].detach(), torch.amax(y, dim=2)


class ConvModule(nn.Module):
    """Conv + norm + activation in a configurable order, NHWC (mmcv's
    ``ConvModule``, ``models/mmcv/conv_module.py:44-164``)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, use_bias: bool = True,
                 normalization: Optional[str] = "batch",
                 activation: Optional[str] = "relu",
                 order: Tuple[str, str, str] = ("conv", "norm", "act")):
        super().__init__()
        self.order, self.stride, self.padding = tuple(order), stride, padding
        self.conv = nn.Conv2d(in_ch, features, kernel_size, bias=use_bias)
        norm_ch = (in_ch if self.order.index("norm") < self.order.index(
            "conv") else features)
        self.norm = _norm(normalization, norm_ch)
        self.act = ACTIVATIONS[activation] if activation else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for step in self.order:
            if step == "conv":
                x = _conv_nhwc(x, self.conv.weight, self.conv.bias,
                               self.stride, self.padding)
            elif step == "norm" and self.norm is not None:
                x = self.norm(x)
            elif step == "act" and self.act is not None:
                x = self.act(x)
        return x


class WSConv(nn.Module):
    """Weight-standardised convolution (mmcv ``ConvWS2d``): the kernel is
    mean/std-normalised over its input axes before the convolution, NHWC.
    ``padding`` an int, ``"SAME"`` (flax's default) or ``"VALID"``."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), strides=1,
                 padding="SAME", use_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        kh, kw = kernel_size
        self.strides, self.padding, self.eps = strides, padding, eps
        self.weight = nn.Parameter(torch.randn(features, in_ch, kh, kw)
                                   * math.sqrt(2.0 / (in_ch * kh * kw)))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, correction=0)
        return _conv_nhwc(x, (w - mu) / (std + self.eps), self.bias,
                          self.strides, self.padding)


class Scale(nn.Module):
    """A learnable scalar multiplier (mmcv ``Scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale
