"""Inception-ResNet-V2 (port of bpbreid_tpu/models/inceptionresnetv2.py).

Residual inception blocks (ten Block35, twenty Block17, nine Block8 and
the last Block8 without its ReLU) whose branches' concatenation goes
through a 1x1 conv with bias (``conv2d``) and is added at a scale; the
``BasicConv2d`` of inceptionv4 (BN eps 1e-3), unpadded stem convs and
max pools, a padding-excluding average pool in Mixed-5b. The part-based
call returns the 1536-channel ``conv2d_7b`` map.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense
from bpbreid_tpu_torch.models.inceptionv4 import (AvgPoolExcl, BasicConv2d,
                                                  _Branches, _seq)
from bpbreid_tpu_torch.models.zoo import classify, conv

__all__ = ['ResidualBlock', 'InceptionResNetV2', 'inceptionresnetv2']


class ResidualBlock(nn.Module):
    """Block35 / Block17 / Block8: ``relu(conv2d(cat(branches)) * scale +
    x)`` (no ReLU with ``relu=False``)."""

    def __init__(self, channels, branches, mixed, scale, relu=True,
                 dtype=torch.float32):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.order = tuple(branches)
        for name, module in branches.items():
            setattr(self, name, module)
        self.conv2d = conv(mixed, channels, 1, bias=True, dtype=dtype)

    def forward(self, x):
        mix = torch.cat([getattr(self, n)(x) for n in self.order], dim=1)
        out = self.conv2d(mix) * self.scale + x
        return F.relu(out) if self.relu else out


def _block35(dtype):
    seq = lambda *specs: _seq(dtype, *specs)
    return ResidualBlock(320, dict(
        branch0=BasicConv2d(320, 32, 1, dtype=dtype),
        branch1=seq((320, 32, 1), (32, 32, 3, 1, 1)),
        branch2=seq((320, 32, 1), (32, 48, 3, 1, 1), (48, 64, 3, 1, 1))),
        128, 0.17, dtype=dtype)


def _block17(dtype):
    return ResidualBlock(1088, dict(
        branch0=BasicConv2d(1088, 192, 1, dtype=dtype),
        branch1=_seq(dtype, (1088, 128, 1), (128, 160, (1, 7), 1, (0, 3)),
                     (160, 192, (7, 1), 1, (3, 0)))), 384, 0.10, dtype=dtype)


def _block8(scale, relu, dtype):
    return ResidualBlock(2080, dict(
        branch0=BasicConv2d(2080, 192, 1, dtype=dtype),
        branch1=_seq(dtype, (2080, 192, 1), (192, 224, (1, 3), 1, (0, 1)),
                     (224, 256, (3, 1), 1, (1, 0)))), 448, scale, relu,
        dtype)


class InceptionResNetV2(nn.Module):
    """(JAX :56)"""

    def __init__(self, num_classes, loss='softmax', dtype=torch.float32):
        super().__init__()
        self.loss = loss
        b = lambda *s: BasicConv2d(*s, dtype=dtype)
        seq = lambda *specs: _seq(dtype, *specs)
        self.conv2d_1a = b(3, 32, 3, 2)
        self.conv2d_2a = b(32, 32, 3)
        self.conv2d_2b = b(32, 64, 3, 1, 1)
        self.conv2d_3b = b(64, 80, 1)
        self.conv2d_4a = b(80, 192, 3)
        self.mixed_5b = _Branches(
            ('branch0', 'branch1', 'branch2', 'branch3'),
            branch0=b(192, 96, 1),
            branch1=seq((192, 48, 1), (48, 64, 5, 1, 2)),
            branch2=seq((192, 64, 1), (64, 96, 3, 1, 1), (96, 96, 3, 1, 1)),
            branch3=nn.Sequential(AvgPoolExcl(), b(192, 64, 1)))
        self.repeat = nn.Sequential(*(_block35(dtype) for _ in range(10)))
        self.mixed_6a = _Branches(
            ('branch0', 'branch1', 'pool'), branch0=b(320, 384, 3, 2),
            branch1=seq((320, 256, 1), (256, 256, 3, 1, 1),
                        (256, 384, 3, 2)))
        self.repeat_1 = nn.Sequential(*(_block17(dtype) for _ in range(20)))
        self.mixed_7a = _Branches(
            ('branch0', 'branch1', 'branch2', 'pool'),
            branch0=seq((1088, 256, 1), (256, 384, 3, 2)),
            branch1=seq((1088, 256, 1), (256, 288, 3, 2)),
            branch2=seq((1088, 256, 1), (256, 288, 3, 1, 1),
                        (288, 320, 3, 2)))
        self.repeat_2 = nn.Sequential(*(_block8(0.20, True, dtype)
                                        for _ in range(9)))
        self.block8 = _block8(1.0, False, dtype)
        self.conv2d_7b = b(2080, 1536, 1)
        self.feature_dim = 1536
        if loss != 'part_based':
            self.classifier = Dense(1536, num_classes, dtype=dtype)

    def forward(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4a(self.conv2d_3b(F.max_pool2d(x, 3, 2)))
        x = self.repeat(self.mixed_5b(F.max_pool2d(x, 3, 2)))
        x = self.mixed_7a(self.repeat_1(self.mixed_6a(x)))
        x = self.conv2d_7b(self.block8(self.repeat_2(x)))
        if self.loss == 'part_based':
            return x
        return classify(self, x.mean(dim=(2, 3)))


def inceptionresnetv2(num_classes, loss='softmax', pretrained=True,
                      dtype=torch.float32, **kwargs):
    return InceptionResNetV2(num_classes, loss, dtype)
