"""InceptionV4 (port of bpbreid_tpu/models/inceptionv4.py).

``BasicConv2d`` (conv + BN with eps 1e-3 + ReLU) at torch's
``features.<i>`` indices: the stem, Mixed-3a/4a/5a, four Inception-A,
Reduction-A, seven Inception-B, Reduction-B and three Inception-C
blocks. The average-pool branches leave the padding out of their count
(``count_include_pad=False``) and the max pools take no padding, as in
the torch port. The part-based call returns the 1536-channel map.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense
from bpbreid_tpu_torch.models.zoo import ConvBNReLU, classify

__all__ = ['BasicConv2d', 'InceptionV4', 'inceptionv4']


def BasicConv2d(cin, cout, kernel, stride=1, padding=0, dtype=torch.float32):
    """conv (no bias, explicit padding) + BN (eps 1e-3) + ReLU (JAX :24)."""
    return ConvBNReLU(cin, cout, kernel, stride, padding, eps=1e-3,
                      dtype=dtype)


def AvgPoolExcl():
    """3x3 stride-1 average pool, padding out of the count."""
    return nn.AvgPool2d(3, 1, 1, count_include_pad=False)


class _Branches(nn.Module):
    """Named branches run on one input and concatenated in ``order``;
    ``'pool'`` is the unpadded max pool of the input."""

    def __init__(self, order, **branches):
        super().__init__()
        self.order = order
        for name, module in branches.items():
            setattr(self, name, module)

    def forward(self, x):
        return torch.cat([F.max_pool2d(x, 3, 2) if name == 'pool'
                          else getattr(self, name)(x)
                          for name in self.order], dim=1)


def _seq(dtype, *specs):
    """An ``nn.Sequential`` of ``BasicConv2d(*spec)``."""
    return nn.Sequential(*(BasicConv2d(*s, dtype=dtype) for s in specs))


class InceptionC(nn.Module):
    """(JAX :136) the branches that split in two."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        b = lambda *s: BasicConv2d(*s, dtype=dtype)
        self.branch0 = b(1536, 256, 1)
        self.branch1_0 = b(1536, 384, 1)
        self.branch1_1a = b(384, 256, (1, 3), 1, (0, 1))
        self.branch1_1b = b(384, 256, (3, 1), 1, (1, 0))
        self.branch2_0 = b(1536, 384, 1)
        self.branch2_1 = b(384, 448, (3, 1), 1, (1, 0))
        self.branch2_2 = b(448, 512, (1, 3), 1, (0, 1))
        self.branch2_3a = b(512, 256, (1, 3), 1, (0, 1))
        self.branch2_3b = b(512, 256, (3, 1), 1, (1, 0))
        self.branch3 = nn.Sequential(AvgPoolExcl(), b(1536, 256, 1))

    def forward(self, x):
        b1 = self.branch1_0(x)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        return torch.cat([self.branch0(x), self.branch1_1a(b1),
                          self.branch1_1b(b1), self.branch2_3a(b2),
                          self.branch2_3b(b2), self.branch3(x)], dim=1)


class InceptionV4(nn.Module):
    """(JAX :57)"""

    def __init__(self, num_classes, loss='softmax', dtype=torch.float32):
        super().__init__()
        self.loss = loss
        b = lambda *s: BasicConv2d(*s, dtype=dtype)
        seq = lambda *specs: _seq(dtype, *specs)
        pool = AvgPoolExcl
        layers = [b(3, 32, 3, 2), b(32, 32, 3), b(32, 64, 3, 1, 1),
                  _Branches(('pool', 'conv'), conv=b(64, 96, 3, 2)),
                  _Branches(('branch0', 'branch1'),
                            branch0=seq((160, 64, 1), (64, 96, 3)),
                            branch1=seq((160, 64, 1),
                                        (64, 64, (1, 7), 1, (0, 3)),
                                        (64, 64, (7, 1), 1, (3, 0)),
                                        (64, 96, 3))),
                  _Branches(('conv', 'pool'), conv=b(192, 192, 3, 2))]
        for _ in range(4):                              # Inception-A
            layers.append(_Branches(
                ('branch0', 'branch1', 'branch2', 'branch3'),
                branch0=b(384, 96, 1),
                branch1=seq((384, 64, 1), (64, 96, 3, 1, 1)),
                branch2=seq((384, 64, 1), (64, 96, 3, 1, 1),
                            (96, 96, 3, 1, 1)),
                branch3=nn.Sequential(pool(), b(384, 96, 1))))
        layers.append(_Branches(                        # Reduction-A
            ('branch0', 'branch1', 'pool'), branch0=b(384, 384, 3, 2),
            branch1=seq((384, 192, 1), (192, 224, 3, 1, 1),
                        (224, 256, 3, 2))))
        for _ in range(7):                              # Inception-B
            layers.append(_Branches(
                ('branch0', 'branch1', 'branch2', 'branch3'),
                branch0=b(1024, 384, 1),
                branch1=seq((1024, 192, 1), (192, 224, (1, 7), 1, (0, 3)),
                            (224, 256, (7, 1), 1, (3, 0))),
                branch2=seq((1024, 192, 1), (192, 192, (7, 1), 1, (3, 0)),
                            (192, 224, (1, 7), 1, (0, 3)),
                            (224, 224, (7, 1), 1, (3, 0)),
                            (224, 256, (1, 7), 1, (0, 3))),
                branch3=nn.Sequential(pool(), b(1024, 128, 1))))
        layers.append(_Branches(                        # Reduction-B
            ('branch0', 'branch1', 'pool'),
            branch0=seq((1024, 192, 1), (192, 192, 3, 2)),
            branch1=seq((1024, 256, 1), (256, 256, (1, 7), 1, (0, 3)),
                        (256, 320, (7, 1), 1, (3, 0)), (320, 320, 3, 2))))
        layers += [InceptionC(dtype) for _ in range(3)]
        self.features = nn.Sequential(*layers)
        self.feature_dim = 1536
        if loss != 'part_based':
            self.classifier = Dense(1536, num_classes, dtype=dtype)

    def forward(self, x):
        x = self.features(x)
        if self.loss == 'part_based':
            return x
        return classify(self, x.mean(dim=(2, 3)))


def inceptionv4(num_classes, loss='softmax', pretrained=True,
                dtype=torch.float32, **kwargs):
    return InceptionV4(num_classes, loss, dtype)
