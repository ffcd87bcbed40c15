"""OSNet, OSNet-IBN and OSNet-AIN: omni-scale re-id networks (port of
bpbreid_tpu/models/osnet.py).

Residual blocks whose 1- to 4-deep streams of ``LightConv3x3`` (a 1x1
conv, a depthwise 3x3 conv with ``groups=C``, BN, ReLU) are merged
through one shared channel gate. The instance norms (``InstanceNorm``,
torch's ``InstanceNorm2d(affine=True)``) of the IBN and AIN variants
normalize in f32 as flax's ``GroupNorm(num_groups=C)`` does in JAX.

Two layouts, as in JAX: the classic one (``osnet_x*``,
``osnet_ibn_x1_0``) puts each transition (1x1 conv + 2x2 average pool)
at the end of its stage (``conv2.2``, ``conv3.2``); the AIN layout
(``osnet_ain_x1_0``) names them ``pool2`` and ``pool3`` and its blocks'
streams ``conv2.<t>.layers.<i>``. Module names follow the torchreid
``state_dict``, as the flax paths do.

Outputs: the part-based call returns the ``conv5`` map, ``[N,
channels[3], Hf, Wf]`` (no ``fc`` and no classifier are built then);
otherwise the ``fc`` embedding (``fc_dim`` 512: Dense, BN, ReLU) in eval
mode and the class scores (``'softmax'``) or ``(scores, embedding)``
(``'triplet'``) in train mode. ``feature_dim`` is the width of what the
model returns: ``channels[3]`` for the part-based map (JAX reports
``fc_dim`` there, which is not the map's width below ``osnet_x1_0``).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (Dense, FastBatchNorm,
                                             InstanceNorm, PConv)

__all__ = ['ConvLayer', 'Conv1x1', 'Conv1x1Linear', 'LightConv3x3',
           'LightConvStream', 'ChannelGate', 'OSBlock', 'OSBlockAIN',
           'OSNet', 'osnet_x1_0', 'osnet_x0_75', 'osnet_x0_5',
           'osnet_x0_25', 'osnet_ibn_x1_0', 'osnet_ain_x1_0']


def _conv(cin, cout, kernel, stride=1, groups=1, bias=False,
          dtype=torch.float32):
    # a flax nn.Conv in JAX: float in every int8 mode
    return PConv(cin, cout, kernel, stride, kernel // 2, bias=bias,
                 groups=groups, dtype=dtype, quant=False)


class ConvLayer(nn.Module):
    """Conv + BN (or instance norm, ``use_in``) + ReLU (JAX :34)."""

    def __init__(self, cin, cout, kernel=3, stride=1, use_in=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride, dtype=dtype)
        self.bn = InstanceNorm(cout, dtype=dtype) if use_in \
            else FastBatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Conv1x1(nn.Module):
    """1x1 conv + BN + ReLU."""

    def __init__(self, cin, cout, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv = _conv(cin, cout, 1, stride, dtype=dtype)
        self.bn = FastBatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Conv1x1Linear(nn.Module):
    """1x1 conv + BN (none with ``use_bn=False``), no activation."""

    def __init__(self, cin, cout, stride=1, use_bn=True,
                 dtype=torch.float32):
        super().__init__()
        self.conv = _conv(cin, cout, 1, stride, dtype=dtype)
        self.bn = FastBatchNorm(cout, dtype=dtype) if use_bn else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class LightConv3x3(nn.Module):
    """1x1 conv + depthwise 3x3 conv (``groups=C``, cuDNN) + BN + ReLU
    (JAX :76)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(cin, cout, 1, dtype=dtype)
        self.conv2 = _conv(cout, cout, 3, groups=cout, dtype=dtype)
        self.bn = FastBatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv2(self.conv1(x))))


class LightConvStream(nn.Module):
    """``depth`` chained ``LightConv3x3`` (``layers.<i>``)."""

    def __init__(self, cin, cout, depth, dtype=torch.float32):
        super().__init__()
        self.layers = nn.Sequential(*(
            LightConv3x3(cin if i == 0 else cout, cout, dtype)
            for i in range(depth)))

    def forward(self, x):
        return self.layers(x)


class ChannelGate(nn.Module):
    """Channel gates from the globally pooled map: 1x1 convs ``fc1``
    (C -> max(1, C // 16)), ReLU, ``fc2``, sigmoid (JAX :114)."""

    def __init__(self, channels, reduction=16, dtype=torch.float32):
        super().__init__()
        mid = max(1, channels // reduction)
        self.fc1 = _conv(channels, mid, 1, bias=True, dtype=dtype)
        self.fc2 = _conv(mid, channels, 1, bias=True, dtype=dtype)

    def forward(self, x):
        g = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(g)


class OSBlock(nn.Module):
    """Classic omni-scale block: streams ``conv2a`` (depth 1) to
    ``conv2d`` (depth 4) through the shared ``gate``; ``use_in`` adds an
    instance norm (``IN``) after the residual (JAX :135)."""

    def __init__(self, cin, cout, use_in=False, reduction=4,
                 dtype=torch.float32):
        super().__init__()
        mid = cout // reduction
        self.conv1 = Conv1x1(cin, mid, dtype=dtype)
        self.conv2a = LightConv3x3(mid, mid, dtype)
        for name, depth in (('conv2b', 2), ('conv2c', 3), ('conv2d', 4)):
            setattr(self, name, nn.Sequential(*(
                LightConv3x3(mid, mid, dtype) for _ in range(depth))))
        self.gate = ChannelGate(mid, dtype=dtype)
        self.conv3 = Conv1x1Linear(mid, cout, dtype=dtype)
        self.downsample = Conv1x1Linear(cin, cout, dtype=dtype) \
            if cin != cout else None
        self.IN = InstanceNorm(cout, dtype=dtype) if use_in else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = sum(self.gate(s(x1)) for s in (self.conv2a, self.conv2b,
                                            self.conv2c, self.conv2d))
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv3(x2) + identity
        if self.IN is not None:
            out = self.IN(out)
        return F.relu(out)


class OSBlockAIN(nn.Module):
    """AIN-layout omni-scale block: ``T`` streams ``conv2.<t>`` of depth
    t + 1; ``in_inside`` puts an instance norm (``IN``) on ``conv3``'s
    output instead of its BN, inside the residual (JAX :177)."""

    def __init__(self, cin, cout, in_inside=False, reduction=4, T=4,
                 dtype=torch.float32):
        super().__init__()
        mid = cout // reduction
        self.conv1 = Conv1x1(cin, mid, dtype=dtype)
        self.conv2 = nn.ModuleList(LightConvStream(mid, mid, t, dtype)
                                   for t in range(1, T + 1))
        self.gate = ChannelGate(mid, dtype=dtype)
        self.conv3 = Conv1x1Linear(mid, cout, use_bn=not in_inside,
                                   dtype=dtype)
        self.IN = InstanceNorm(cout, dtype=dtype) if in_inside else None
        self.downsample = Conv1x1Linear(cin, cout, dtype=dtype) \
            if cin != cout else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = sum(self.gate(stream(x1)) for stream in self.conv2)
        x3 = self.conv3(x2)
        if self.IN is not None:
            x3 = self.IN(x3)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(x3 + identity)


class _Transition(nn.Sequential):
    """1x1 conv + BN + ReLU, then a 2x2 average pool (``<name>.0``)."""

    def __init__(self, channels, dtype):
        super().__init__(Conv1x1(channels, channels, dtype=dtype),
                         nn.AvgPool2d(2, 2))


class OSNet(nn.Module):
    """Omni-Scale Network (JAX :203). ``blocks``: per stage, the kinds
    'os' (plain), 'os_in' (instance norm after the residual), 'ain'
    (AIN plain) and 'ain_in' (instance norm inside the residual)."""

    def __init__(self, num_classes=1000, loss='softmax',
                 blocks=(('os', 'os'),) * 3, channels=(64, 256, 384, 512),
                 fc_dim=512, conv1_IN=False, ain_layout=False,
                 dtype=torch.float32):
        super().__init__()
        self.loss = loss
        ch = channels
        self.conv1 = ConvLayer(3, ch[0], 7, 2, use_in=conv1_IN, dtype=dtype)
        cin = ch[0]
        for si, kinds in enumerate(blocks):
            cout = ch[si + 1]
            stage = []
            for kind in kinds:
                stage.append(self._block(kind, cin, cout, dtype))
                cin = cout
            if si < 2 and not ain_layout:
                stage.append(_Transition(cout, dtype))
            setattr(self, 'conv{}'.format(si + 2), nn.Sequential(*stage))
            if si < 2 and ain_layout:
                setattr(self, 'pool{}'.format(si + 2),
                        _Transition(cout, dtype))
        self.conv5 = Conv1x1(ch[3], ch[3], dtype=dtype)
        self.ain_layout = ain_layout
        # the part-based model reads the map: no fc head, no classifier
        self.fc_dim = fc_dim if loss != 'part_based' and fc_dim else 0
        dim = ch[3]
        if self.fc_dim:
            self.fc = nn.Sequential(
                Dense(dim, self.fc_dim, dtype=dtype),
                FastBatchNorm(self.fc_dim, channel_dim=-1, dtype=dtype),
                nn.ReLU())
            dim = self.fc_dim
        self.feature_dim = dim
        if loss != 'part_based':
            self.classifier = Dense(dim, num_classes, dtype=dtype)

    @staticmethod
    def _block(kind, cin, cout, dtype):
        if kind in ('os', 'os_in'):
            return OSBlock(cin, cout, use_in=kind == 'os_in', dtype=dtype)
        if kind in ('ain', 'ain_in'):
            return OSBlockAIN(cin, cout, in_inside=kind == 'ain_in',
                              dtype=dtype)
        raise ValueError(kind)

    def featuremaps(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.conv2(x)
        if self.ain_layout:
            x = self.pool2(x)
        x = self.conv3(x)
        if self.ain_layout:
            x = self.pool3(x)
        return self.conv5(self.conv4(x))

    def forward(self, x):
        f = self.featuremaps(x)
        if self.loss == 'part_based':
            return f                                    # [N, C, Hf, Wf]
        v = f.mean(dim=(2, 3))
        if self.fc_dim:
            v = self.fc(v)
        if not self.training:
            return v
        y = self.classifier(v)
        if self.loss == 'softmax':
            return y
        if self.loss == 'triplet':
            return y, v
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def _osnet(channels, blocks=(('os', 'os'),) * 3, conv1_IN=False,
           ain_layout=False, num_classes=1000, loss='softmax',
           dtype=torch.float32, **kwargs):
    # pretrained and BPBReID's backbone arguments (last_stride,
    # enable_dim_reduction, dim_reduction_channels, pretrained_path):
    # ignored, as in JAX
    del kwargs
    return OSNet(num_classes=num_classes, loss=loss, blocks=blocks,
                 channels=tuple(channels), conv1_IN=conv1_IN,
                 ain_layout=ain_layout, dtype=dtype)


def osnet_x1_0(num_classes=1000, pretrained=True, loss='softmax', **kwargs):
    return _osnet((64, 256, 384, 512), num_classes=num_classes, loss=loss,
                  **kwargs)


def osnet_x0_75(num_classes=1000, pretrained=True, loss='softmax', **kwargs):
    return _osnet((48, 192, 288, 384), num_classes=num_classes, loss=loss,
                  **kwargs)


def osnet_x0_5(num_classes=1000, pretrained=True, loss='softmax', **kwargs):
    return _osnet((32, 128, 192, 256), num_classes=num_classes, loss=loss,
                  **kwargs)


def osnet_x0_25(num_classes=1000, pretrained=True, loss='softmax', **kwargs):
    return _osnet((16, 64, 96, 128), num_classes=num_classes, loss=loss,
                  **kwargs)


def osnet_ibn_x1_0(num_classes=1000, pretrained=True, loss='softmax',
                   **kwargs):
    # instance norm in the stem and after the residual of stage conv2
    return _osnet((64, 256, 384, 512),
                  blocks=(('os_in', 'os_in'), ('os', 'os'), ('os', 'os')),
                  conv1_IN=True, num_classes=num_classes, loss=loss,
                  **kwargs)


def osnet_ain_x1_0(num_classes=1000, pretrained=True, loss='softmax',
                   **kwargs):
    return _osnet((64, 256, 384, 512),
                  blocks=(('ain_in', 'ain_in'), ('ain', 'ain_in'),
                          ('ain_in', 'ain')),
                  conv1_IN=True, ain_layout=True, num_classes=num_classes,
                  loss=loss, **kwargs)
