"""ShuffleNetV2 ``x0_5``, ``x1_0``, ``x1_5`` and ``x2_0`` (port of
bpbreid_tpu/models/shufflenetv2.py).

Inverted residuals that split the channels in two (or, at stride 2,
feed both halves of the block with the whole input), run one half
through a 1x1 conv, a depthwise 3x3 conv and a 1x1 conv, concatenate and
shuffle. Names follow torchvision's Sequential indices (``branch2.3`` is
the depthwise conv). The part-based call returns the ``conv5`` map (1024
channels, 2048 for ``x2_0``).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import channel_shuffle, classify, conv

__all__ = ['InvertedResidual', 'ShuffleNetV2', 'shufflenet_v2_x0_5',
           'shufflenet_v2_x1_0', 'shufflenet_v2_x1_5', 'shufflenet_v2_x2_0']


def _conv_bn(cin, cout, kernel, stride=1, groups=1, dtype=torch.float32):
    return [conv(cin, cout, kernel, stride, groups=groups, dtype=dtype),
            FastBatchNorm(cout, dtype=dtype)]


class InvertedResidual(nn.Module):
    """(JAX :40)"""

    def __init__(self, cin, cout, stride=1, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        bf = cout // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                *_conv_bn(cin, cin, 3, stride, cin, dtype),
                *_conv_bn(cin, bf, 1, dtype=dtype), nn.ReLU())
        b2_in = cin if stride > 1 else cin // 2
        self.branch2 = nn.Sequential(
            *_conv_bn(b2_in, bf, 1, dtype=dtype), nn.ReLU(),
            *_conv_bn(bf, bf, 3, stride, bf, dtype),
            *_conv_bn(bf, bf, 1, dtype=dtype), nn.ReLU())

    def forward(self, x):
        if self.stride > 1:
            b1, b2 = self.branch1(x), self.branch2(x)
        else:
            x1, x2 = x.chunk(2, dim=1)
            b2 = self.branch2(x2)
            b1 = x1.to(b2.dtype)
        return channel_shuffle(torch.cat([b1, b2], dim=1), 2)


class ShuffleNetV2(nn.Module):
    """(JAX :77)"""

    def __init__(self, num_classes, loss='softmax',
                 stages_repeats=(4, 8, 4),
                 stages_out_channels=(24, 116, 232, 464, 1024),
                 dtype=torch.float32):
        super().__init__()
        self.loss = loss
        oc = stages_out_channels
        self.conv1 = nn.Sequential(*_conv_bn(3, oc[0], 3, 2, dtype=dtype),
                                   nn.ReLU())
        c = oc[0]
        for si, (repeats, feats) in enumerate(zip(stages_repeats, oc[1:4])):
            blocks = [InvertedResidual(c, feats, 2, dtype)]
            blocks += [InvertedResidual(feats, feats, 1, dtype)
                       for _ in range(1, repeats)]
            setattr(self, 'stage{}'.format(si + 2), nn.Sequential(*blocks))
            c = feats
        self.conv5 = nn.Sequential(*_conv_bn(c, oc[4], 1, dtype=dtype),
                                   nn.ReLU())
        self.feature_dim = oc[4]
        if loss != 'part_based':
            self.classifier = Dense(oc[4], num_classes, dtype=dtype)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.conv5(self.stage4(self.stage3(self.stage2(x))))
        if self.loss == 'part_based':
            return x
        return classify(self, x.mean(dim=(2, 3)))


def _shufflenet(repeats, channels, num_classes, loss, dtype=torch.float32,
                **kwargs):
    return ShuffleNetV2(num_classes, loss, tuple(repeats), tuple(channels),
                        dtype)


def shufflenet_v2_x0_5(num_classes, loss='softmax', pretrained=True,
                       **kwargs):
    return _shufflenet([4, 8, 4], [24, 48, 96, 192, 1024], num_classes,
                       loss, **kwargs)


def shufflenet_v2_x1_0(num_classes, loss='softmax', pretrained=True,
                       **kwargs):
    return _shufflenet([4, 8, 4], [24, 116, 232, 464, 1024], num_classes,
                       loss, **kwargs)


def shufflenet_v2_x1_5(num_classes, loss='softmax', pretrained=True,
                       **kwargs):
    return _shufflenet([4, 8, 4], [24, 176, 352, 704, 1024], num_classes,
                       loss, **kwargs)


def shufflenet_v2_x2_0(num_classes, loss='softmax', pretrained=True,
                       **kwargs):
    return _shufflenet([4, 8, 4], [24, 244, 488, 976, 2048], num_classes,
                       loss, **kwargs)
