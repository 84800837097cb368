"""ResNet-34 feature pyramid, counterpart of the JAX package's
``models/resnet.py`` (reference ``models/resnet.py:118-216``).

Returns the 6-level pyramid ``[conv1 (/2), layer1 (/4), layer2 (/8),
layer3 (/16), layer4 (/32), global average]``, channel-last like the JAX
package.  Module names are torchvision's.  Convolutions run NCHW
internally in the compute dtype; batch norm computes in f32 (f64 in a
float64 copy of the model).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dtypes import widen
from .layers import Norm


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(c: int) -> Norm:
    return Norm(c, "batch", channel_axis=1)


def _apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = _bn(cout)
        self.conv2 = _conv(cout, cout, 3, 1)
        self.bn2 = _bn(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.ModuleList([_conv(cin, cout, 1, stride),
                                             _bn(cout)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(_apply_conv(self.conv1, x), relu=True)
        y = self.bn2(_apply_conv(self.conv2, y))
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(_apply_conv(conv, x))
        return F.relu(y + identity)


class ResNetPyramid(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        cin = 64
        for stage, (blocks, cout) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(BasicBlock(cin, cout, stride))
                cin = cout
            setattr(self, f"layer{stage + 1}", nn.ModuleList(layer))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> pyramid, maps (B, h, w, C), global (B, 512)."""
        x = x.permute(0, 3, 1, 2)
        x = self.bn1(_apply_conv(self.conv1, x), relu=True)
        out = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x)
            out.append(x)
        glob = widen(x).mean(dim=(2, 3)).to(x.dtype)
        return [o.permute(0, 2, 3, 1) for o in out] + [glob]

