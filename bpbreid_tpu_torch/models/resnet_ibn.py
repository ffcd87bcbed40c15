"""IBN-Net ResNet-50s: ``resnet50_ibn_a`` and ``resnet50_ibn_b`` (port of
bpbreid_tpu/models/resnet_ibn.py).

- IBN-a: bn1 of every bottleneck but those of the 512-planes stage is an
  ``IBNLayer`` (half instance norm, half batch norm);
- IBN-b: an instance-norm stem ``bn1``, and an instance norm (``IN``)
  on the output of the last block of layers 1 and 2.

Last stride 2, as in JAX (the constructors ignore ``last_stride``). The
part-based call returns the ``[N, 2048, Hf, Wf]`` map; otherwise the
pooled embedding in eval mode and the class scores (``'softmax'``) or
``(scores, embedding)`` (``'triplet'``) in train mode. Module names
follow the torchreid ``state_dict``.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (Dense, FastBatchNorm,
                                             InstanceNorm, PConv)
from bpbreid_tpu_torch.models.resnet_fastreid import IBNLayer

__all__ = ['IBNBottleneck', 'ResNetIBN', 'resnet50_ibn_a', 'resnet50_ibn_b']


def _conv(cin, cout, kernel, stride=1, dtype=torch.float32):
    # a flax nn.Conv in JAX: float in every int8 mode
    return PConv(cin, cout, kernel, stride, kernel // 2, bias=False,
                 dtype=dtype, quant=False)


class IBNBottleneck(nn.Module):
    """Bottleneck with IBN-a's ``bn1`` (``ibn_a``) or IBN-b's instance
    norm after the residual (``in_after``; JAX :32)."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 ibn_a=False, in_after=False, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = IBNLayer(planes, dtype) if ibn_a \
            else FastBatchNorm(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, stride, dtype=dtype)
        self.bn2 = FastBatchNorm(planes, dtype=dtype)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = FastBatchNorm(planes * 4, dtype=dtype)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes * 4, 1, stride, dtype=dtype),
            FastBatchNorm(planes * 4, dtype=dtype)) if has_downsample \
            else None
        self.IN = InstanceNorm(planes * 4, dtype=dtype) if in_after else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        out = out + residual
        if self.IN is not None:
            out = self.IN(out)
        return F.relu(out)


class ResNetIBN(nn.Module):
    """IBN-Net ResNet (JAX :71); ``variant`` 'a' or 'b'."""

    def __init__(self, num_classes=1000, loss='softmax', variant='a',
                 layers=(3, 4, 6, 3), dtype=torch.float32):
        super().__init__()
        self.loss = loss
        self.conv1 = _conv(3, 64, 7, 2, dtype=dtype)
        self.bn1 = InstanceNorm(64, dtype=dtype) if variant == 'b' \
            else FastBatchNorm(64, dtype=dtype)
        inplanes = 64
        for s, (planes, stride) in enumerate(zip((64, 128, 256, 512),
                                                 (1, 2, 2, 2))):
            blocks = []
            for b in range(layers[s]):
                st = stride if b == 0 else 1
                blocks.append(IBNBottleneck(
                    inplanes, planes, st, st != 1 or inplanes != planes * 4,
                    ibn_a=variant == 'a' and planes != 512,
                    in_after=variant == 'b' and s < 2
                    and b == layers[s] - 1, dtype=dtype))
                inplanes = planes * 4
            setattr(self, 'layer{}'.format(s + 1), nn.Sequential(*blocks))
        self.feature_dim = inplanes
        if loss != 'part_based':
            self.classifier = Dense(inplanes, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, 'layer{}'.format(s))(x)
        if self.loss == 'part_based':
            return x
        v = x.mean(dim=(2, 3))
        if not self.training:
            return v
        y = self.classifier(v)
        if self.loss == 'softmax':
            return y
        if self.loss == 'triplet':
            return y, v
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def resnet50_ibn_a(num_classes=1000, loss='softmax', pretrained=False,
                   dtype=torch.float32, **kwargs):
    # last_stride and BPBReID's other backbone arguments: ignored, as in
    # JAX
    del kwargs
    return ResNetIBN(num_classes, loss, 'a', dtype=dtype)


def resnet50_ibn_b(num_classes=1000, loss='softmax', pretrained=False,
                   dtype=torch.float32, **kwargs):
    del kwargs
    return ResNetIBN(num_classes, loss, 'b', dtype=dtype)
