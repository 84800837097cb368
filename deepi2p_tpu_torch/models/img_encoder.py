"""Image tower, counterpart of the JAX package's ``models/img_encoder.py``:
a ResNet-34 trunk whose pyramid levels 3, 4 and 5 are used."""
from __future__ import annotations

import torch
from torch import nn

from .resnet import ResNetPyramid


class ImageEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ResNetPyramid()

    def forward(self, img: torch.Tensor):
        """img (B, H, W, 3) -> (s16 (B,H/16,W/16,256), s32 (B,H/32,W/32,512),
        global (B, 512))."""
        pyramid = self.backbone(img)
        return pyramid[3], pyramid[4], pyramid[5]
