"""Dilated-CNN + hourglass feature extractor, NCHW.

Counterpart of the JAX package's `models/feature.py`: the three-scale
pyramid [1/8 @ 2C, 1/4 @ 2C, 1/2 @ C]. Plain PyTorch convolutions (cuDNN
on the card), as the JAX package leaves these to XLA.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from lwsnet_tpu_torch.models.blocks import Conv, ConvBN, DeconvBN


class Hourglass(nn.Module):
    """Encoder-decoder over the 1/2-res map; emits [1/8@2C, 1/4@2C, 1/2@C]."""

    def __init__(self, c: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 2 * c, stride=2, dtype=dtype)
        self.ConvBN_1 = ConvBN(2 * c, 2 * c, dtype=dtype)
        self.ConvBN_2 = ConvBN(2 * c, 2 * c, stride=2, dtype=dtype)
        self.ConvBN_3 = ConvBN(2 * c, 2 * c, dtype=dtype)
        self.DeconvBN_0 = DeconvBN(2 * c, 2 * c, dtype=dtype)
        self.DeconvBN_1 = DeconvBN(2 * c, c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = F.relu(self.ConvBN_0(x))
        pre = F.relu(self.ConvBN_1(out))
        out = F.relu(self.ConvBN_2(pre))
        feat8 = F.relu(self.ConvBN_3(out))
        feat4 = F.relu(self.DeconvBN_0(feat8) + pre)
        feat2 = self.DeconvBN_1(feat4)
        return [feat8, feat4, feat2]


class FeatureExtractor(nn.Module):
    """dres0 (two dilated convs, halves resolution), dres1 (residual
    block), dres2 (hourglass, with a 1/2-res skip) and the classif1 head."""

    def __init__(self, c: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(3, c // 2, stride=2, dilation=2, dtype=dtype)
        self.ConvBN_1 = ConvBN(c // 2, c, dilation=4, dtype=dtype)
        self.ConvBN_2 = ConvBN(c, c // 2, dilation=2, dtype=dtype)
        self.ConvBN_3 = ConvBN(c // 2, c, dilation=2, dtype=dtype)
        self.Hourglass_0 = Hourglass(c, dtype=dtype)
        self.ConvBN_4 = ConvBN(c, c, dtype=dtype)
        self.Conv_0 = Conv(c, c)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = F.relu(self.ConvBN_0(x))
        out = F.relu(self.ConvBN_1(out))
        res = F.relu(self.ConvBN_2(out))
        out = self.ConvBN_3(res) + out
        feat8, feat4, feat2 = self.Hourglass_0(out)
        feat2 = F.relu(self.ConvBN_4(feat2 + out))
        return [feat8, feat4, self.Conv_0(feat2, self.dtype)]
