"""Xception (port of bpbreid_tpu/models/xception.py).

Blocks of separable convs (a depthwise 3x3 conv ``conv1`` and a 1x1
``pointwise``) with BN and ReLU in torch's Sequential order (``rep.<i>``:
ReLUs and the pool take indices too) and a 1x1 conv + BN skip where the
width or the stride changes; unpadded stem convs. The part-based call
returns the 2048-channel ``bn4`` map.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import classify, conv

__all__ = ['SeparableConv2d', 'XBlock', 'Xception', 'xception']


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (``conv1``) then 1x1 (``pointwise``) (JAX
    ``_sep_conv``)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv1 = conv(cin, cin, 3, groups=cin, dtype=dtype)
        self.pointwise = conv(cin, cout, 1, dtype=dtype)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class XBlock(nn.Module):
    """(JAX :35)"""

    def __init__(self, cin, out_filters, reps, strides=1,
                 start_with_relu=True, grow_first=True, dtype=torch.float32):
        super().__init__()
        ops, c = [], cin

        def sep(cout):
            nonlocal c
            ops.extend([nn.ReLU(), SeparableConv2d(c, cout, dtype),
                        FastBatchNorm(cout, dtype=dtype)])
            c = cout
        if grow_first:
            sep(out_filters)
        for _ in range(reps - 1):
            sep(c)
        if not grow_first:
            sep(out_filters)
        if not start_with_relu:
            ops = ops[1:]
        if strides != 1:
            ops.append(nn.MaxPool2d(3, strides, 1))
        self.rep = nn.Sequential(*ops)
        self.skip = self.skipbn = None
        if out_filters != cin or strides != 1:
            self.skip = conv(cin, out_filters, 1, strides, dtype=dtype)
            self.skipbn = FastBatchNorm(out_filters, dtype=dtype)

    def forward(self, x):
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class Xception(nn.Module):
    """(JAX :87)"""

    def __init__(self, num_classes, loss='softmax', dtype=torch.float32):
        super().__init__()
        self.loss = loss
        self.conv1 = conv(3, 32, 3, 2, padding=0, dtype=dtype)
        self.bn1 = FastBatchNorm(32, dtype=dtype)
        self.conv2 = conv(32, 64, 3, padding=0, dtype=dtype)
        self.bn2 = FastBatchNorm(64, dtype=dtype)
        specs = [(128, 2, 2, False, True), (256, 2, 2, True, True),
                 (728, 2, 2, True, True)] \
            + [(728, 3, 1, True, True)] * 8 \
            + [(1024, 2, 2, True, False)]
        c = 64
        for i, (out_f, reps, strides, swr, gf) in enumerate(specs):
            setattr(self, 'block{}'.format(i + 1),
                    XBlock(c, out_f, reps, strides, swr, gf, dtype))
            c = out_f
        self.n_blocks = len(specs)
        self.conv3 = SeparableConv2d(1024, 1536, dtype)
        self.bn3 = FastBatchNorm(1536, dtype=dtype)
        self.conv4 = SeparableConv2d(1536, 2048, dtype)
        self.bn4 = FastBatchNorm(2048, dtype=dtype)
        self.feature_dim = 2048
        if loss != 'part_based':
            self.classifier = Dense(2048, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for i in range(1, self.n_blocks + 1):
            x = getattr(self, 'block{}'.format(i))(x)
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.relu(self.bn4(self.conv4(x)))
        if self.loss == 'part_based':
            return x
        return classify(self, x.mean(dim=(2, 3)))


def xception(num_classes, loss='softmax', pretrained=True,
             dtype=torch.float32, **kwargs):
    return Xception(num_classes, loss, dtype)
