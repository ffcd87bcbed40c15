"""DenseNet-121/169/201/161 and ``densenet121_fc512`` (port of
bpbreid_tpu/models/densenet.py).

Dense blocks of bottleneck layers (BN-ReLU-1x1 conv, BN-ReLU-3x3 conv,
concatenated to the input), transitions (BN-ReLU-1x1 conv to half the
channels, 2x2 average pool) and a final BN + ReLU, named as torchvision's
``state_dict`` (``features.denseblock1.denselayer1.conv1``). The
part-based call returns the ``features.norm5`` map (no ``fc`` and no
classifier are built then), so ``feature_dim`` is its width (1024 for
``densenet121_fc512``, where JAX reports the ``fc`` head's 512).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import classify, conv, fc_layers

__all__ = ['DenseLayer', 'DenseNet', 'densenet121', 'densenet169',
           'densenet201', 'densenet161', 'densenet121_fc512']


class DenseLayer(nn.Module):
    """``norm1`` -> ReLU -> ``conv1`` (1x1, ``bn_size * growth_rate``) ->
    ``norm2`` -> ReLU -> ``conv2`` (3x3, ``growth_rate``), concatenated to
    the input (JAX :27)."""

    def __init__(self, cin, growth_rate, bn_size, dtype=torch.float32):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = FastBatchNorm(cin, dtype=dtype)
        self.conv1 = conv(cin, mid, 1, dtype=dtype)
        self.norm2 = FastBatchNorm(mid, dtype=dtype)
        self.conv2 = conv(mid, growth_rate, 3, dtype=dtype)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x.to(out.dtype), out], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin, dtype):
        super().__init__()
        self.norm = FastBatchNorm(cin, dtype=dtype)
        self.conv = conv(cin, cin // 2, 1, dtype=dtype)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """(JAX :43)"""

    def __init__(self, num_classes, loss='softmax', growth_rate=32,
                 block_config=(6, 12, 24, 16), num_init_features=64,
                 bn_size=4, fc_dims=None, dtype=torch.float32):
        super().__init__()
        self.loss = loss
        f = self.features = nn.Module()
        f.conv0 = conv(3, num_init_features, 7, 2, dtype=dtype)
        f.norm0 = FastBatchNorm(num_init_features, dtype=dtype)
        c = num_init_features
        self.n_blocks = len(block_config)
        for bi, n_layers in enumerate(block_config):
            block = nn.Module()
            for li in range(n_layers):
                setattr(block, 'denselayer{}'.format(li + 1),
                        DenseLayer(c, growth_rate, bn_size, dtype))
                c += growth_rate
            setattr(f, 'denseblock{}'.format(bi + 1), block)
            if bi != self.n_blocks - 1:
                setattr(f, 'transition{}'.format(bi + 1),
                        _Transition(c, dtype))
                c //= 2
        f.norm5 = FastBatchNorm(c, dtype=dtype)
        self.fc = None
        if loss != 'part_based':
            self.fc, c = fc_layers(c, fc_dims, dtype)
            self.classifier = Dense(c, num_classes, dtype=dtype)
        self.feature_dim = c

    def featuremaps(self, x):
        f = self.features
        x = F.max_pool2d(F.relu(f.norm0(f.conv0(x))), 3, 2, 1)
        for bi in range(1, self.n_blocks + 1):
            for layer in getattr(f, 'denseblock{}'.format(bi)).children():
                x = layer(x)
            if bi != self.n_blocks:
                x = getattr(f, 'transition{}'.format(bi))(x)
        return F.relu(f.norm5(x))

    def forward(self, x):
        f = self.featuremaps(x)
        if self.loss == 'part_based':
            return f
        v = f.mean(dim=(2, 3))
        if self.fc is not None:
            v = self.fc(v)
        return classify(self, v)


def _densenet(growth_rate, block_config, num_init_features, num_classes,
              loss, fc_dims=None, dtype=torch.float32, **kwargs):
    # pretrained and BPBReID's backbone arguments: ignored, as in JAX
    return DenseNet(num_classes, loss, growth_rate, tuple(block_config),
                    num_init_features, fc_dims=fc_dims, dtype=dtype)


def densenet121(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _densenet(32, (6, 12, 24, 16), 64, num_classes, loss, **kwargs)


def densenet169(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _densenet(32, (6, 12, 32, 32), 64, num_classes, loss, **kwargs)


def densenet201(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _densenet(32, (6, 12, 48, 32), 64, num_classes, loss, **kwargs)


def densenet161(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _densenet(48, (6, 12, 36, 24), 96, num_classes, loss, **kwargs)


def densenet121_fc512(num_classes, loss='softmax', pretrained=True,
                      **kwargs):
    return _densenet(32, (6, 12, 24, 16), 64, num_classes, loss,
                     fc_dims=(512,), **kwargs)
