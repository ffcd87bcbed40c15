"""SENet: ``se_resnet50/101/152``, ``se_resnet50_fc512``,
``se_resnext50_32x4d``, ``se_resnext101_32x4d`` and ``senet154`` (port
of bpbreid_tpu/models/senet.py).

Squeeze-and-excitation bottlenecks: ``se_resnet`` strides its 1x1
``conv1`` (Caffe), ``se_resnext`` its grouped 3x3 ``conv2``, and
``senet154`` doubles ``conv1``'s width, starts from three 3x3 convs and
downsamples with 3x3 convs after the first stage. The stem's max pool
is in ceil mode. ``se_resnet50_fc512`` has the last stride 1 and a 512-d
``fc`` head. The part-based call returns layer4's ``[N, 2048, Hf, Wf]``
map (no ``fc`` and no classifier are built then), so ``feature_dim`` is
2048 there; JAX's is the ``fc`` head's 512 for ``se_resnet50_fc512``,
a width the map does not have.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import classify, conv, fc_layers

__all__ = ['SEModule', 'SEBottleneck', 'SENet', 'senet154', 'se_resnet50',
           'se_resnet50_fc512', 'se_resnet101', 'se_resnet152',
           'se_resnext50_32x4d', 'se_resnext101_32x4d']


class SEModule(nn.Module):
    """Global mean -> 1x1 conv ``fc1`` (C / reduction) -> ReLU -> ``fc2``
    -> sigmoid gate (JAX :38)."""

    def __init__(self, channels, reduction, dtype=torch.float32):
        super().__init__()
        self.fc1 = conv(channels, channels // reduction, 1, bias=True,
                        dtype=dtype)
        self.fc2 = conv(channels // reduction, channels, 1, bias=True,
                        dtype=dtype)

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class SEBottleneck(nn.Module):
    """The SE bottleneck of each ``style`` (JAX ``SEBottleneckBase``
    :53)."""
    expansion = 4

    def __init__(self, inplanes, planes, groups, reduction, stride=1,
                 has_downsample=False, ds_kernel=1, style='se_resnet',
                 base_width=4, dtype=torch.float32):
        super().__init__()
        if style == 'senet154':
            w1, w2, s1, s2 = planes * 2, planes * 4, 1, stride
        elif style == 'se_resnext':
            w1 = w2 = int(math.floor(planes * (base_width / 64.0)) * groups)
            s1, s2 = 1, stride
        else:                                   # se_resnet (Caffe style)
            w1 = w2 = planes
            s1, s2 = stride, 1
        self.conv1 = conv(inplanes, w1, 1, s1, dtype=dtype)
        self.bn1 = FastBatchNorm(w1, dtype=dtype)
        self.conv2 = conv(w1, w2, 3, s2, groups=groups, dtype=dtype)
        self.bn2 = FastBatchNorm(w2, dtype=dtype)
        self.conv3 = conv(w2, planes * 4, 1, dtype=dtype)
        self.bn3 = FastBatchNorm(planes * 4, dtype=dtype)
        self.downsample = nn.Sequential(
            conv(inplanes, planes * 4, ds_kernel, stride, dtype=dtype),
            FastBatchNorm(planes * 4, dtype=dtype)) if has_downsample \
            else None
        self.se_module = SEModule(planes * 4, reduction, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.se_module(out) + residual)


class SENet(nn.Module):
    """(JAX :110) Returns the layer4 map (``loss='part_based'``), else the
    pooled embedding (through ``fc`` with ``fc_dims``) in eval mode and
    the class scores or ``(scores, embedding)`` in train mode."""

    def __init__(self, num_classes=1000, loss='softmax', style='se_resnet',
                 layers=(3, 4, 6, 3), groups=1, reduction=16, inplanes=64,
                 input_3x3=False, downsample_kernel_size=1, last_stride=2,
                 fc_dims=None, dtype=torch.float32):
        super().__init__()
        self.loss = loss
        self.layer0 = nn.Module()
        if input_3x3:
            cin = 3
            for i, (feats, stride) in enumerate(((64, 2), (64, 1),
                                                 (inplanes, 1))):
                setattr(self.layer0, 'conv{}'.format(i + 1),
                        conv(cin, feats, 3, stride, dtype=dtype))
                setattr(self.layer0, 'bn{}'.format(i + 1),
                        FastBatchNorm(feats, dtype=dtype))
                cin = feats
            self.stem = 3
        else:
            self.layer0.conv1 = conv(3, inplanes, 7, 2, dtype=dtype)
            self.layer0.bn1 = FastBatchNorm(inplanes, dtype=dtype)
            self.stem = 1
        cin = inplanes
        strides = (1, 2, 2, last_stride)
        for s, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for b in range(layers[s]):
                stride = strides[s] if b == 0 else 1
                needs_ds = stride != 1 or cin != planes * 4
                blocks.append(SEBottleneck(
                    cin, planes, groups, reduction, stride, needs_ds,
                    ds_kernel=1 if s == 0 else downsample_kernel_size,
                    style=style, dtype=dtype))
                cin = planes * 4
            setattr(self, 'layer{}'.format(s + 1), nn.Sequential(*blocks))
        self.fc = None
        if loss != 'part_based':
            self.fc, cin = fc_layers(cin, fc_dims, dtype)
            self.classifier = Dense(cin, num_classes, dtype=dtype)
        self.feature_dim = cin

    def featuremaps(self, x):
        for i in range(1, self.stem + 1):
            x = F.relu(getattr(self.layer0, 'bn{}'.format(i))(
                getattr(self.layer0, 'conv{}'.format(i))(x)))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for i in range(1, 5):
            x = getattr(self, 'layer{}'.format(i))(x)
        return x

    def forward(self, x):
        f = self.featuremaps(x)
        if self.loss == 'part_based':
            return f
        v = f.mean(dim=(2, 3))
        if self.fc is not None:
            v = self.fc(v)
        return classify(self, v)


def _senet(style, layers, num_classes, loss, groups=1, reduction=16,
           inplanes=64, input_3x3=False, downsample_kernel_size=1,
           last_stride=2, fc_dims=None, dtype=torch.float32, **kwargs):
    # pretrained and BPBReID's other backbone arguments: ignored, as in
    # JAX; its last_stride is taken, as in JAX
    return SENet(num_classes, loss, style, tuple(layers), groups, reduction,
                 inplanes, input_3x3, downsample_kernel_size, last_stride,
                 fc_dims, dtype)


def senet154(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _senet('senet154', [3, 8, 36, 3], num_classes, loss, groups=64,
                  inplanes=128, input_3x3=True, downsample_kernel_size=3,
                  **kwargs)


def se_resnet50(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _senet('se_resnet', [3, 4, 6, 3], num_classes, loss, **kwargs)


def se_resnet50_fc512(num_classes, loss='softmax', pretrained=True,
                      **kwargs):
    # JAX passes last_stride=1 beside the caller's, so as a BPBReID
    # backbone (which passes its own) it raises TypeError; the port takes
    # the caller's, as resnet50_fc512 does
    kwargs.setdefault('last_stride', 1)
    return _senet('se_resnet', [3, 4, 6, 3], num_classes, loss,
                  fc_dims=(512,), **kwargs)


def se_resnet101(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _senet('se_resnet', [3, 4, 23, 3], num_classes, loss, **kwargs)


def se_resnet152(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _senet('se_resnet', [3, 8, 36, 3], num_classes, loss, **kwargs)


def se_resnext50_32x4d(num_classes, loss='softmax', pretrained=True,
                       **kwargs):
    return _senet('se_resnext', [3, 4, 6, 3], num_classes, loss, groups=32,
                  **kwargs)


def se_resnext101_32x4d(num_classes, loss='softmax', pretrained=True,
                        **kwargs):
    return _senet('se_resnext', [3, 4, 23, 3], num_classes, loss, groups=32,
                  **kwargs)
