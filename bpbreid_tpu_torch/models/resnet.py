"""ResNet backbones (port of bpbreid_tpu/models/resnet.py).

resnet18/34/50/101/152, the ResNeXt variants and ``resnet50_fc512``,
channel-first, with the re-id ``last_stride`` and the part-based early
return of the feature map (``loss='part_based'``). Module names follow
the torchvision ``state_dict`` (``conv1``, ``bn1``, ``layer1.0.conv1``,
``fc.0``, ``classifier``), as the flax paths do, so JAX variables load
with ``utils.weights.load_jax_variables``. Every BN is a
``FastBatchNorm``: on the card the BN kernels (K3) in train mode,
``bn_apply`` in eval mode.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (BasicBlock, Bottleneck, Dense,
                                             FastBatchNorm, PConv, ResLayer)
from bpbreid_tpu_torch.ops.quant import set_quant_paths

__all__ = ['ResNet', 'resnet18', 'resnet34', 'resnet50', 'resnet101',
           'resnet152', 'resnext50_32x4d', 'resnext101_32x8d',
           'resnet50_fc512', 'RESNETS']


class ResNet(nn.Module):
    """Residual network returning the spatial feature map
    (``loss='part_based'``), else the pooled embedding in eval mode and
    the class scores (``'softmax'``) or ``(scores, embedding)``
    (``'triplet'``) in train mode."""

    def __init__(self, num_classes=1000, loss='softmax', block=Bottleneck,
                 layers=(3, 4, 6, 3), last_stride=2, fc_dims=None, groups=1,
                 width_per_group=64, dtype=torch.float32):
        super().__init__()
        self.loss = loss
        self.dtype = dtype
        # a flax nn.Conv in JAX: float in int8 eval too
        self.conv1 = PConv(3, 64, 7, 2, 3, bias=False, dtype=dtype,
                           quant=False)
        self.bn1 = FastBatchNorm(64, dtype=dtype)
        kw = dict(groups=groups, base_width=width_per_group, dtype=dtype)
        inplanes = 64
        for i, (planes, stride) in enumerate(zip(
                (64, 128, 256, 512), (1, 2, 2, last_stride))):
            setattr(self, 'layer{}'.format(i + 1),
                    ResLayer(block, inplanes, planes, layers[i], stride, **kw))
            inplanes = planes * block.expansion
        # the part-based model reads the map: no fc head, no classifier
        self.fc_dims = tuple(fc_dims or ()) if loss != 'part_based' else ()
        if self.fc_dims:
            fc = []
            for dim in self.fc_dims:
                # torch Sequential indices: Linear 3i, BN 3i+1, ReLU 3i+2
                fc += [Dense(inplanes, dim, dtype=dtype),
                       FastBatchNorm(dim, channel_dim=-1, dtype=dtype),
                       nn.ReLU()]
                inplanes = dim
            self.fc = nn.Sequential(*fc)
        self.feature_dim = inplanes
        if loss != 'part_based':
            self.classifier = Dense(inplanes, num_classes, dtype=dtype)
        set_quant_paths(self)

    def featuremaps(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, 'layer{}'.format(i))(x)
        return x

    def forward(self, x):
        f = self.featuremaps(x)
        if self.loss == 'part_based':
            return f                                    # [N, D, Hf, Wf]
        v = f.mean(dim=(2, 3))
        if self.fc_dims:
            v = self.fc(v)
        if not self.training:
            return v
        y = self.classifier(v)
        if self.loss == 'softmax':
            return y
        if self.loss == 'triplet':
            return y, v
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def _resnet(block, layers, num_classes=1000, loss='softmax', last_stride=2,
            fc_dims=None, groups=1, width_per_group=64, dtype=torch.float32,
            **kwargs):
    # pretrained, enable_dim_reduction, ...: ignored, as in JAX
    del kwargs
    return ResNet(num_classes=num_classes, loss=loss, block=block,
                  layers=tuple(layers), last_stride=last_stride,
                  fc_dims=fc_dims, groups=groups,
                  width_per_group=width_per_group, dtype=dtype)


def resnet18(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(BasicBlock, [2, 2, 2, 2], num_classes, loss, **kwargs)


def resnet34(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(BasicBlock, [3, 4, 6, 3], num_classes, loss, **kwargs)


def resnet50(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(Bottleneck, [3, 4, 6, 3], num_classes, loss, **kwargs)


def resnet101(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(Bottleneck, [3, 4, 23, 3], num_classes, loss, **kwargs)


def resnet152(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(Bottleneck, [3, 8, 36, 3], num_classes, loss, **kwargs)


def resnext50_32x4d(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(Bottleneck, [3, 4, 6, 3], num_classes, loss, groups=32,
                   width_per_group=4, **kwargs)


def resnext101_32x8d(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _resnet(Bottleneck, [3, 4, 23, 3], num_classes, loss, groups=32,
                   width_per_group=8, **kwargs)


def resnet50_fc512(num_classes, loss='softmax', pretrained=True, **kwargs):
    kwargs.setdefault('last_stride', 1)
    return _resnet(Bottleneck, [3, 4, 6, 3], num_classes, loss,
                   fc_dims=(512,), **kwargs)


RESNETS = {
    'resnet18': resnet18, 'resnet34': resnet34, 'resnet50': resnet50,
    'resnet101': resnet101, 'resnet152': resnet152,
    'resnext50_32x4d': resnext50_32x4d, 'resnext101_32x8d': resnext101_32x8d,
    'resnet50_fc512': resnet50_fc512,
}
