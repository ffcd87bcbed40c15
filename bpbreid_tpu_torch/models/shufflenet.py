"""ShuffleNet (v1, three groups) (port of
bpbreid_tpu/models/shufflenet.py).

Bottlenecks of a grouped 1x1 conv, a channel shuffle, a depthwise 3x3
conv and a grouped 1x1 conv; a stride-2 block concatenates a 3x3 average
pool of its input (padding counted, ``count_include_pad=True``) in front
of its output. The part-based call returns stage4's 960-channel map.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import channel_shuffle, classify, conv

__all__ = ['ShuffleBottleneck', 'ShuffleNet', 'shufflenet']

# num_groups -> stage output channels (JAX :20)
_CFG = {1: [144, 288, 576], 2: [200, 400, 800], 3: [240, 480, 960],
        4: [272, 544, 1088], 8: [384, 768, 1536]}


class ShuffleBottleneck(nn.Module):
    """(JAX :29)"""

    def __init__(self, cin, out_channels, stride, num_groups,
                 group_conv1x1=True, dtype=torch.float32):
        super().__init__()
        self.stride, self.num_groups = stride, num_groups
        mid = out_channels // 4
        if stride == 2:
            out_channels -= cin
        g1 = num_groups if group_conv1x1 else 1
        self.conv1 = conv(cin, mid, 1, groups=g1, dtype=dtype)
        self.bn1 = FastBatchNorm(mid, dtype=dtype)
        self.conv2 = conv(mid, mid, 3, stride, groups=mid, dtype=dtype)
        self.bn2 = FastBatchNorm(mid, dtype=dtype)
        self.conv3 = conv(mid, out_channels, 1, groups=num_groups,
                          dtype=dtype)
        self.bn3 = FastBatchNorm(out_channels, dtype=dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = channel_shuffle(out, self.num_groups)
        out = self.bn2(self.conv2(out))
        out = self.bn3(self.conv3(out))
        if self.stride == 2:
            res = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
            return F.relu(torch.cat([res.to(out.dtype), out], dim=1))
        return F.relu(x + out)


class ShuffleNet(nn.Module):
    """(JAX :70)"""

    def __init__(self, num_classes, loss='softmax', num_groups=3,
                 dtype=torch.float32):
        super().__init__()
        self.loss = loss
        cfg = _CFG[num_groups]
        self.conv1 = nn.Sequential(conv(3, 24, 3, 2, dtype=dtype),
                                   FastBatchNorm(24, dtype=dtype))
        c = 24
        for si, (n_blocks, feats) in enumerate(zip((4, 8, 4), cfg)):
            blocks = []
            for b in range(n_blocks):
                blocks.append(ShuffleBottleneck(
                    c, feats, 2 if b == 0 else 1, num_groups,
                    group_conv1x1=not (si == 0 and b == 0), dtype=dtype))
                c = feats
            setattr(self, 'stage{}'.format(si + 2), nn.Sequential(*blocks))
        self.feature_dim = c
        if loss != 'part_based':
            self.classifier = Dense(c, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        x = self.stage4(self.stage3(self.stage2(x)))
        if self.loss == 'part_based':
            return x
        return classify(self, x.mean(dim=(2, 3)))


def shufflenet(num_classes, loss='softmax', pretrained=True,
               dtype=torch.float32, **kwargs):
    return ShuffleNet(num_classes, loss, dtype=dtype)
