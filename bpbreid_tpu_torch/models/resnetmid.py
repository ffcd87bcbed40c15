"""ResNet-mid: a ResNet-50 with mid-level feature fusion (port of
bpbreid_tpu/models/resnetmid.py).

The three blocks of layer4 are kept apart: the pooled outputs of the
first two are concatenated and fused through ``fc_fusion`` (Dense, BN,
ReLU), then concatenated with the third's, a ``fc_dims[-1] + 2048``
embedding (3072). The part-based call returns the third block's
2048-channel map, and ``feature_dim`` is then 2048 (JAX reports 3072
there, the width of the embedding it does not return).
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (Bottleneck, Dense,
                                             FastBatchNorm, PConv, ResLayer)
from bpbreid_tpu_torch.ops.quant import set_quant_paths

__all__ = ['ResNetMid', 'resnet50mid']


class ResNetMid(nn.Module):
    """(JAX :19)"""

    def __init__(self, num_classes, loss='softmax', layers=(3, 4, 6, 3),
                 last_stride=2, fc_dims=(1024,), dtype=torch.float32):
        super().__init__()
        self.loss = loss
        # a flax nn.Conv in JAX: float in int8 eval too
        self.conv1 = PConv(3, 64, 7, 2, 3, bias=False, dtype=dtype,
                           quant=False)
        self.bn1 = FastBatchNorm(64, dtype=dtype)
        self.layer1 = ResLayer(Bottleneck, 64, 64, layers[0], 1, dtype=dtype)
        self.layer2 = ResLayer(Bottleneck, 256, 128, layers[1], 2,
                               dtype=dtype)
        self.layer3 = ResLayer(Bottleneck, 512, 256, layers[2], 2,
                               dtype=dtype)
        # three separate Bottlenecks in JAX: no shared quantization points
        self.layer4 = ResLayer(Bottleneck, 1024, 512, 3, last_stride,
                               quant_blocks=False, dtype=dtype)
        self.fc_dims = tuple(fc_dims) if loss != 'part_based' else ()
        if self.fc_dims:
            fusion, dim = [], 2 * 2048
            for d in self.fc_dims:
                # torch Sequential indices: Linear 3i, BN 3i+1, ReLU 3i+2
                fusion += [Dense(dim, d, dtype=dtype),
                           FastBatchNorm(d, channel_dim=-1, dtype=dtype),
                           nn.ReLU()]
                dim = d
            self.fc_fusion = nn.Sequential(*fusion)
            self.feature_dim = self.fc_dims[-1] + 2048
            self.classifier = Dense(self.feature_dim, num_classes,
                                    dtype=dtype)
        else:
            self.feature_dim = 2048
        set_quant_paths(self)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer3(self.layer2(self.layer1(x)))
        x4a = self.layer4[0](x)
        x4b = self.layer4[1](x4a)
        x4c = self.layer4[2](x4b)
        if self.loss == 'part_based':
            return x4c
        v4ab = self.fc_fusion(torch.cat([x4a.mean(dim=(2, 3)),
                                         x4b.mean(dim=(2, 3))], dim=-1))
        v = torch.cat([v4ab, x4c.mean(dim=(2, 3))], dim=-1)
        if not self.training:
            return v
        y = self.classifier(v)
        if self.loss == 'softmax':
            return y
        if self.loss == 'triplet':
            return y, v
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def resnet50mid(num_classes=1000, loss='softmax', pretrained=True,
                dtype=torch.float32, **kwargs):
    # last_stride and BPBReID's other backbone arguments: ignored, as in
    # JAX
    del kwargs
    return ResNetMid(num_classes, loss, fc_dims=(1024,), dtype=dtype)
