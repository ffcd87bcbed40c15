"""MuDeep, the multiscale deep network (port of
bpbreid_tpu/models/mudeep.py).

Inception-style multiscale streams (``block2``: MultiScaleA, ``block3``:
the reduction, ``block4``: MultiScaleB's four streams), a fusion of the
four streams through learned per-channel gates (``block5.a1`` ...
``a4``, ``[1, 256, 1, 1]``, drawn uniformly from [0, 1)) and a 4x4
average pool; then a 4096-d ``fc`` head and the classifier. The input is
fixed at 256x128 (the head reads ``256 x 16 x 8`` values). As in JAX (and
torchreid), the class scores are returned in eval mode too. The
part-based call returns the fused map, ``[N, 256, H/16, W/16]`` (no
``fc`` or classifier are built then), so ``feature_dim`` is 256 there;
JAX's is the ``fc`` head's 4096.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import ConvBNReLU

__all__ = ['MuDeep', 'mudeep']

# the fused map of the fixed 256x128 input: 256 channels of 16x8
MUDEEP_FUSED = 256 * 16 * 8


def _cb(cin, cout, kernel, stride=1, padding=0, dtype=torch.float32):
    """conv (with bias) + BN + ReLU (JAX ``ConvBlock``)."""
    return ConvBNReLU(cin, cout, kernel, stride, padding, bias=True,
                      dtype=dtype)


class _Streams(nn.Module):
    """Named streams run on one input and concatenated in order."""

    def __init__(self, **streams):
        super().__init__()
        self.order = tuple(streams)
        for name, module in streams.items():
            setattr(self, name, module)

    def outputs(self, x):
        return [getattr(self, n)(x) for n in self.order]

    def forward(self, x):
        return torch.cat(self.outputs(x), dim=1)


class _Reduction(_Streams):
    """block3: a 3x3 stride-2 max pool beside its streams."""

    def forward(self, x):
        return torch.cat([F.max_pool2d(x, 3, 2, 1)] + self.outputs(x), dim=1)


class _Fusion(nn.Module):
    """The gates ``a1`` ... ``a4`` of the fused streams."""

    def __init__(self, channels=256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, 'a{}'.format(i),
                    nn.Parameter(torch.empty(1, channels, 1, 1)))

    @torch.no_grad()
    def flax_init(self, generator):
        for i in range(1, 5):
            getattr(self, 'a{}'.format(i)).uniform_(0.0, 1.0,
                                                    generator=generator)

    def forward(self, streams):
        return sum(getattr(self, 'a{}'.format(i + 1)) * s
                   for i, s in enumerate(streams))


class MuDeep(nn.Module):
    """(JAX :39)"""

    def __init__(self, num_classes, loss='softmax', dtype=torch.float32):
        super().__init__()
        self.loss = loss
        seq = lambda *specs: nn.Sequential(*(_cb(*s, dtype=dtype)
                                             for s in specs))
        self.block1 = nn.Module()
        self.block1.conv1 = _cb(3, 48, 3, 1, 1, dtype)
        self.block1.conv2 = _cb(48, 96, 3, 1, 1, dtype)
        self.block2 = _Streams(
            stream1=seq((96, 96, 1), (96, 24, 3, 1, 1)),
            stream2=nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                  _cb(96, 24, 1, dtype=dtype)),
            stream3=_cb(96, 24, 1, dtype=dtype),
            stream4=seq((96, 16, 1), (16, 24, 3, 1, 1), (24, 24, 3, 1, 1)))
        self.block3 = _Reduction(
            stream2=_cb(96, 96, 3, 2, 1, dtype),
            stream3=seq((96, 48, 1), (48, 56, 3, 1, 1), (56, 64, 3, 2, 1)))
        self.block4 = _Streams(
            stream1=nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                  _cb(256, 256, 1, dtype=dtype)),
            stream2=seq((256, 64, 1), (64, 128, (1, 3), 1, (0, 1)),
                        (128, 256, (3, 1), 1, (1, 0))),
            stream3=_cb(256, 256, 1, dtype=dtype),
            stream4=seq((256, 64, 1), (64, 64, (1, 3), 1, (0, 1)),
                        (64, 128, (3, 1), 1, (1, 0)),
                        (128, 128, (1, 3), 1, (0, 1)),
                        (128, 256, (3, 1), 1, (1, 0))))
        self.block5 = _Fusion(256)
        if loss == 'part_based':
            self.feature_dim = 256
            return
        self.feature_dim = 4096
        self.fc = nn.Sequential(Dense(MUDEEP_FUSED, 4096, dtype=dtype),
                                FastBatchNorm(4096, channel_dim=-1,
                                              dtype=dtype),
                                nn.ReLU())
        self.classifier = Dense(4096, num_classes, dtype=dtype)

    def featuremaps(self, x):
        x = self.block1.conv2(self.block1.conv1(x))
        x = self.block3(self.block2(F.max_pool2d(x, 3, 2, 1)))
        return F.avg_pool2d(self.block5(self.block4.outputs(x)), 4, 4)

    def forward(self, x):
        x = self.featuremaps(x)
        if self.loss == 'part_based':
            return x
        # torch flattens NCHW: channel-major
        v = self.fc(x.reshape(x.shape[0], -1))
        y = self.classifier(v)
        if self.loss == 'softmax':
            return y
        if self.loss == 'triplet':
            return y, v
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def mudeep(num_classes, loss='softmax', pretrained=True, dtype=torch.float32,
           **kwargs):
    return MuDeep(num_classes, loss, dtype)
