"""MobileNetV2 ``x1_0`` and ``x1_4`` (port of
bpbreid_tpu/models/mobilenetv2.py).

Inverted residual bottlenecks: a 1x1 expansion, a depthwise 3x3 conv
(``groups`` = channels) and a linear 1x1 projection, with ReLU6; the
residual where the stride is 1 and the widths match. The part-based call
returns the ``conv9`` map, 1280 channels (1792 for ``x1_4``).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import classify, conv

__all__ = ['ConvBlock', 'InvertedBottleneck', 'MobileNetV2',
           'mobilenetv2_x1_0', 'mobilenetv2_x1_4']


class ConvBlock(nn.Module):
    """``conv`` + ``bn`` + ReLU6 (JAX ``_conv_block``)."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1,
                 dtype=torch.float32):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, groups=groups,
                         dtype=dtype)
        self.bn = FastBatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedBottleneck(nn.Module):
    """(JAX :28)"""

    def __init__(self, cin, cout, expansion, stride=1, dtype=torch.float32):
        super().__init__()
        mid = cin * expansion
        self.use_residual = stride == 1 and cin == cout
        self.conv1 = ConvBlock(cin, mid, 1, dtype=dtype)
        self.dwconv2 = ConvBlock(mid, mid, 3, stride, groups=mid, dtype=dtype)
        self.conv3 = nn.Sequential(conv(mid, cout, 1, dtype=dtype),
                                   FastBatchNorm(cout, dtype=dtype))

    def forward(self, x):
        m = self.conv3(self.dwconv2(self.conv1(x)))
        return x + m if self.use_residual else m


class MobileNetV2(nn.Module):
    """(JAX :49)"""

    def __init__(self, num_classes, width_mult=1.0, loss='softmax',
                 dtype=torch.float32):
        super().__init__()
        self.loss = loss
        wm = width_mult
        c = int(32 * wm)
        self.conv1 = ConvBlock(3, c, 3, 2, dtype=dtype)
        # (expansion t, out channels, blocks n, stride s) a stage
        stages = [(1, int(16 * wm), 1, 1), (6, int(24 * wm), 2, 2),
                  (6, int(32 * wm), 3, 2), (6, int(64 * wm), 4, 2),
                  (6, int(96 * wm), 3, 1), (6, int(160 * wm), 3, 2),
                  (6, int(320 * wm), 1, 1)]
        for si, (t, cout, n, s) in enumerate(stages):
            blocks = []
            for b in range(n):
                blocks.append(InvertedBottleneck(c, cout, t, s if b == 0
                                                 else 1, dtype))
                c = cout
            setattr(self, 'conv{}'.format(si + 2), nn.Sequential(*blocks))
        self.feature_dim = int(1280 * wm) if wm > 1 else 1280
        self.conv9 = ConvBlock(c, self.feature_dim, 1, dtype=dtype)
        if loss != 'part_based':
            self.classifier = Dense(self.feature_dim, num_classes,
                                    dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        for i in range(2, 9):
            x = getattr(self, 'conv{}'.format(i))(x)
        x = self.conv9(x)
        if self.loss == 'part_based':
            return x
        return classify(self, x.mean(dim=(2, 3)))


def mobilenetv2_x1_0(num_classes, loss='softmax', pretrained=True,
                     dtype=torch.float32, **kwargs):
    return MobileNetV2(num_classes, 1.0, loss, dtype)


def mobilenetv2_x1_4(num_classes, loss='softmax', pretrained=True,
                     dtype=torch.float32, **kwargs):
    return MobileNetV2(num_classes, 1.4, loss, dtype)
