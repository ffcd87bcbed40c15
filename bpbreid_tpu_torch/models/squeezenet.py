"""SqueezeNet 1.0 and 1.1, and ``squeezenet1_0_fc512`` (port of
bpbreid_tpu/models/squeezenet.py).

Fire modules (a 1x1 squeeze, then 1x1 and 3x3 expansions concatenated),
an unpadded stem conv and ceil-mode max pools, at torchvision's
``features.<i>`` indices (ReLUs and pools take indices too). The
part-based call returns the last Fire's 512-channel map.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense
from bpbreid_tpu_torch.models.zoo import classify, conv, fc_layers

__all__ = ['Fire', 'SqueezeNet', 'squeezenet1_0', 'squeezenet1_1',
           'squeezenet1_0_fc512']


class Fire(nn.Module):
    """(JAX :29)"""

    def __init__(self, cin, squeeze, expand1x1, expand3x3,
                 dtype=torch.float32):
        super().__init__()
        self.squeeze = conv(cin, squeeze, 1, bias=True, dtype=dtype)
        self.expand1x1 = conv(squeeze, expand1x1, 1, bias=True, dtype=dtype)
        self.expand3x3 = conv(squeeze, expand3x3, 3, bias=True, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], dim=1)


# (kind, arguments) in torchvision's Sequential order (JAX :48)
_V10 = [('conv', 96, 7, 2), ('pool',), ('fire', 16, 64, 64),
        ('fire', 16, 64, 64), ('fire', 32, 128, 128), ('pool',),
        ('fire', 32, 128, 128), ('fire', 48, 192, 192),
        ('fire', 48, 192, 192), ('fire', 64, 256, 256), ('pool',),
        ('fire', 64, 256, 256)]
_V11 = [('conv', 64, 3, 2), ('pool',), ('fire', 16, 64, 64),
        ('fire', 16, 64, 64), ('pool',), ('fire', 32, 128, 128),
        ('fire', 32, 128, 128), ('pool',), ('fire', 48, 192, 192),
        ('fire', 48, 192, 192), ('fire', 64, 256, 256),
        ('fire', 64, 256, 256)]


class SqueezeNet(nn.Module):
    """(JAX :62)"""

    def __init__(self, num_classes, loss='softmax', version=1.0,
                 fc_dims=None, dtype=torch.float32):
        super().__init__()
        self.loss = loss
        layers, c = [], 3
        for item in _V10 if version == 1.0 else _V11:
            if item[0] == 'conv':
                _, feats, k, s = item
                layers += [conv(c, feats, k, s, padding=0, bias=True,
                                dtype=dtype), nn.ReLU()]
                c = feats
            elif item[0] == 'pool':
                layers.append(nn.MaxPool2d(3, 2, ceil_mode=True))
            else:
                _, sq, e1, e3 = item
                layers.append(Fire(c, sq, e1, e3, dtype))
                c = e1 + e3
        self.features = nn.Sequential(*layers)
        self.fc = None
        if loss != 'part_based':
            self.fc, c = fc_layers(c, fc_dims, dtype)
            self.classifier = Dense(c, num_classes, dtype=dtype)
        self.feature_dim = c

    def forward(self, x):
        x = self.features(x)
        if self.loss == 'part_based':
            return x
        v = x.mean(dim=(2, 3))
        if self.fc is not None:
            v = self.fc(v)
        return classify(self, v)


def squeezenet1_0(num_classes, loss='softmax', pretrained=True,
                  dtype=torch.float32, **kwargs):
    return SqueezeNet(num_classes, loss, 1.0, dtype=dtype)


def squeezenet1_0_fc512(num_classes, loss='softmax', pretrained=True,
                        dtype=torch.float32, **kwargs):
    return SqueezeNet(num_classes, loss, 1.0, fc_dims=(512,), dtype=dtype)


def squeezenet1_1(num_classes, loss='softmax', pretrained=True,
                  dtype=torch.float32, **kwargs):
    return SqueezeNet(num_classes, loss, 1.1, dtype=dtype)
