"""fastreid-style ResNet-50 trunks: IBN-a and Non-local variants (port of
bpbreid_tpu/models/resnet_fastreid.py).

A feature-map trunk for BPBReID: the 2048-channel map of layer4 (stride
``last_stride``, 1 by default), whatever the ``loss``. Options: IBN-a
(``with_ibn``: bn1 of the bottlenecks of layers 1-3 batch-norms one half
of its channels and instance-norms the other), SE (``with_se``) and
Non-local blocks after the last blocks of layers 2 and 3 (``with_nl``,
``non_layers`` (0, 2, 3, 0)). The stem's max pool is fastreid's
``MaxPool2d(3, 2, ceil_mode=True)`` without padding.

``NonLocal`` keeps the reference's ``inter_channels = 1`` (the published
checkpoints were trained with it); ``sane_nl=True`` gives the intended
``in_channels // reduc_ratio``. Its ``[N, HW, HW]`` products are
``torch.matmul`` in f32, as JAX computes them outside any Pallas kernel.

Module names follow the fastreid ``state_dict`` (``layer1.0.bn1.IN``,
``layer1.0.bn1.BN``, ``NL_2.0.W.1``), as the flax paths do. Every batch
norm is a ``FastBatchNorm`` (the BN kernels on the card); the
instance norms are ``InstanceNorm``.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (Dense, FastBatchNorm,
                                             InstanceNorm, PConv)

__all__ = ['IBNLayer', 'SELayer', 'NonLocal', 'FRBottleneck',
           'FastReIDResNet', 'fastreid_resnet', 'fastreid_resnet_ibn',
           'fastreid_resnet_nl', 'fastreid_resnet_ibn_nl']


def _conv(cin, cout, kernel, stride=1, bias=False, dtype=torch.float32):
    # a flax nn.Conv in JAX: float in every int8 mode
    return PConv(cin, cout, kernel, stride, kernel // 2, bias=bias,
                 dtype=dtype, quant=False)


class IBNLayer(nn.Module):
    """Instance norm on the first ``planes // 2`` channels, batch norm on
    the rest (``IN`` and ``BN``; JAX :31).

    The BN kernels read contiguous input, and the channel half of an NCHW
    batch is a strided view: the copy is made here, explicitly, and
    counted in ``copies``."""

    def __init__(self, planes, dtype=torch.float32):
        super().__init__()
        self.half = planes // 2
        self.IN = InstanceNorm(self.half, dtype=dtype)
        self.BN = FastBatchNorm(planes - self.half, dtype=dtype)
        self.copies = 0

    def forward(self, x):
        b = x[:, self.half:]
        if not b.is_contiguous():
            b = b.contiguous()
            self.copies += 1
        return torch.cat([self.IN(x[:, :self.half]), self.BN(b)], dim=1)


class SELayer(nn.Module):
    """Squeeze and excitation (``fc.0``, ``fc.2``; JAX :48)."""

    def __init__(self, channels, reduction=16, dtype=torch.float32):
        super().__init__()
        self.fc = nn.Sequential(
            Dense(channels, channels // reduction, bias=False, dtype=dtype),
            nn.ReLU(),
            Dense(channels // reduction, channels, bias=False, dtype=dtype),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class NonLocal(nn.Module):
    """Embedded-gaussian non-local block (JAX :65): ``g``, ``theta``,
    ``phi`` 1x1 convs, ``f = theta^T phi / HW`` in f32, ``y = f g`` in
    f32 from ``f`` in the compute type, then ``W`` (conv + BN) and the
    residual."""

    def __init__(self, channels, sane_nl=False, reduc_ratio=2,
                 dtype=torch.float32):
        super().__init__()
        self.inter = channels // reduc_ratio if sane_nl else 1
        self.g = _conv(channels, self.inter, 1, bias=True, dtype=dtype)
        self.theta = _conv(channels, self.inter, 1, bias=True, dtype=dtype)
        self.phi = _conv(channels, self.inter, 1, bias=True, dtype=dtype)
        self.W = nn.Sequential(
            _conv(self.inter, channels, 1, bias=True, dtype=dtype),
            FastBatchNorm(channels, dtype=dtype))

    def forward(self, x):
        n, _, h, w = x.shape
        g = self.g(x).flatten(2)                       # [N, I, HW]
        theta = self.theta(x).flatten(2)
        phi = self.phi(x).flatten(2)
        f = torch.matmul(theta.transpose(1, 2).float(), phi.float())
        f = f / f.shape[-1]
        y = torch.matmul(f.to(x.dtype).float(), g.transpose(1, 2).float())
        y = y.transpose(1, 2).reshape(n, self.inter, h, w).to(x.dtype)
        return self.W(y) + x


class FRBottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (JAX :93), with IBN-a's ``bn1`` and
    SE as options."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 with_ibn=False, with_se=False, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = IBNLayer(planes, dtype) if with_ibn \
            else FastBatchNorm(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, stride, dtype=dtype)
        self.bn2 = FastBatchNorm(planes, dtype=dtype)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = FastBatchNorm(planes * 4, dtype=dtype)
        self.se = SELayer(planes * 4, dtype=dtype) if with_se else None
        self.downsample = nn.Sequential(
            _conv(inplanes, planes * 4, 1, stride, dtype=dtype),
            FastBatchNorm(planes * 4, dtype=dtype)) if has_downsample \
            else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def ceil_max_pool(x):
    """``MaxPool2d(3, 2, ceil_mode=True)`` without padding (fastreid's
    stem; JAX :147-157 pads the bottom and right with -inf instead)."""
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


class FastReIDResNet(nn.Module):
    """The feature-map trunk (JAX :131): returns ``[N, 2048, Hf, Wf]``."""
    feature_dim = 2048

    def __init__(self, last_stride=1, with_ibn=False, with_se=False,
                 with_nl=False, layers=(3, 4, 6, 3), non_layers=(0, 2, 3, 0),
                 sane_nl=False, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, dtype=dtype)
        self.bn1 = FastBatchNorm(64, dtype=dtype)
        inplanes = 64
        # stage -> the block indices followed by a non-local block
        self.nl_after = {}
        for s, (planes, stride) in enumerate(zip(
                (64, 128, 256, 512), (1, 2, 2, last_stride))):
            blocks = []
            for b in range(layers[s]):
                st = stride if b == 0 else 1
                blocks.append(FRBottleneck(
                    inplanes, planes, st,
                    st != 1 or inplanes != planes * 4,
                    # IBN on layers 1-3 only (the reference's :252-255)
                    with_ibn=with_ibn and s < 3, with_se=with_se,
                    dtype=dtype))
                inplanes = planes * 4
            setattr(self, 'layer{}'.format(s + 1), nn.Sequential(*blocks))
            n_nl = non_layers[s] if with_nl else 0
            if n_nl:
                self.nl_after[s] = sorted(layers[s] - (i + 1)
                                          for i in range(n_nl))
                setattr(self, 'NL_{}'.format(s + 1), nn.ModuleList(
                    NonLocal(inplanes, sane_nl, dtype=dtype)
                    for _ in range(n_nl)))

    def forward(self, x):
        x = ceil_max_pool(F.relu(self.bn1(self.conv1(x))))
        for s in range(4):
            after = self.nl_after.get(s, ())
            for b, block in enumerate(getattr(self, 'layer{}'.format(s + 1))):
                x = block(x)
                if b in after:
                    x = getattr(self, 'NL_{}'.format(s + 1))[
                        after.index(b)](x)
        return x


def _fastreid(with_ibn=False, with_nl=False, last_stride=1,
              dtype=torch.float32, **kwargs):
    # num_classes, loss, pretrained and BPBReID's backbone arguments
    # (enable_dim_reduction, dim_reduction_channels, pretrained_path):
    # ignored, as in JAX
    del kwargs
    return FastReIDResNet(last_stride=last_stride, with_ibn=with_ibn,
                          with_nl=with_nl, dtype=dtype)


def fastreid_resnet(num_classes=1000, pretrained=True, **kwargs):
    return _fastreid(**kwargs)


def fastreid_resnet_ibn(num_classes=1000, pretrained=True, **kwargs):
    return _fastreid(with_ibn=True, **kwargs)


def fastreid_resnet_nl(num_classes=1000, pretrained=True, **kwargs):
    return _fastreid(with_nl=True, **kwargs)


def fastreid_resnet_ibn_nl(num_classes=1000, pretrained=True, **kwargs):
    return _fastreid(with_ibn=True, with_nl=True, **kwargs)
