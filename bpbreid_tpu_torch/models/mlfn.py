"""MLFN, the Multi-Level Factorisation Net (port of
bpbreid_tpu/models/mlfn.py).

Sixteen blocks whose grouped 3x3 conv (32 groups) is gated group by
group by a factor selection module (``fsm``: global mean, two 1x1 conv
+ BN + ReLU, a 1x1 conv + BN + sigmoid to one gate a group); the
concatenated gates join the pooled map in the embedding (``fc_x`` and
``fc_s``, averaged). The part-based call returns the last block's
2048-channel map (no ``fc_x``, ``fc_s`` or classifier are built then), so
``feature_dim`` is 2048 there; JAX's is the embedding's 1024, a width the
map does not have.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import classify, conv

__all__ = ['MLFNBlock', 'MLFN', 'mlfn']


class _GlobalMean(nn.Module):
    def forward(self, x):
        return x.mean(dim=(2, 3), keepdim=True)


class MLFNBlock(nn.Module):
    """(JAX :25) Returns ``(output, gates [N, groups, 1, 1])``."""

    def __init__(self, cin, out_channels, stride, fsm_channels, groups=32,
                 dtype=torch.float32):
        super().__init__()
        mid = out_channels // 2
        self.groups = groups
        # torch Sequential indices: 0 the pool, 3 and 6 ReLUs, 9 the sigmoid
        self.fsm = nn.Sequential(
            _GlobalMean(),
            conv(cin, fsm_channels[0], 1, bias=True, dtype=dtype),
            FastBatchNorm(fsm_channels[0], dtype=dtype), nn.ReLU(),
            conv(fsm_channels[0], fsm_channels[1], 1, bias=True,
                 dtype=dtype),
            FastBatchNorm(fsm_channels[1], dtype=dtype), nn.ReLU(),
            conv(fsm_channels[1], groups, 1, bias=True, dtype=dtype),
            FastBatchNorm(groups, dtype=dtype), nn.Sigmoid())
        self.fm_conv1 = conv(cin, mid, 1, dtype=dtype)
        self.fm_bn1 = FastBatchNorm(mid, dtype=dtype)
        self.fm_conv2 = conv(mid, mid, 3, stride, groups=groups, dtype=dtype)
        self.fm_bn2 = FastBatchNorm(mid, dtype=dtype)
        self.fm_conv3 = conv(mid, out_channels, 1, dtype=dtype)
        self.fm_bn3 = FastBatchNorm(out_channels, dtype=dtype)
        self.downsample = nn.Sequential(
            conv(cin, out_channels, 1, stride, dtype=dtype),
            FastBatchNorm(out_channels, dtype=dtype)) \
            if cin != out_channels or stride > 1 else None

    def forward(self, x):
        s = self.fsm(x)                                  # [N, G, 1, 1]
        out = F.relu(self.fm_bn1(self.fm_conv1(x)))
        out = F.relu(self.fm_bn2(self.fm_conv2(out)))
        # channel c = g * (C / G) + j takes gate g, as the grouped conv
        # lays its groups out
        out = out * s.repeat_interleave(out.shape[1] // self.groups, dim=1)
        out = F.relu(self.fm_bn3(self.fm_conv3(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + out), s


class MLFN(nn.Module):
    """(JAX :82)"""

    def __init__(self, num_classes, loss='softmax', groups=32,
                 channels=(64, 256, 512, 1024, 2048), embed_dim=1024,
                 dtype=torch.float32):
        super().__init__()
        self.loss = loss
        ch = channels
        self.conv1 = conv(3, ch[0], 7, 2, bias=True, dtype=dtype)
        self.bn1 = FastBatchNorm(ch[0], dtype=dtype)
        # (out_channels, stride, fsm_channels) x 16 (JAX :105)
        plan = ([(ch[1], 1, (128, 64))] * 3
                + [(ch[2], 2, (256, 128))] + [(ch[2], 1, (256, 128))] * 3
                + [(ch[3], 2, (512, 128))] + [(ch[3], 1, (512, 128))] * 5
                + [(ch[4], 2, (512, 128))] + [(ch[4], 1, (512, 128))] * 2)
        blocks, c = [], ch[0]
        for cout, stride, fsm in plan:
            blocks.append(MLFNBlock(c, cout, stride, fsm, groups, dtype))
            c = cout
        self.feature = nn.Sequential(*blocks)
        if loss == 'part_based':
            self.feature_dim = c
            return
        self.feature_dim = embed_dim
        self.fc_x = nn.Sequential(conv(c, embed_dim, 1, dtype=dtype),
                                  FastBatchNorm(embed_dim, dtype=dtype))
        self.fc_s = nn.Sequential(
            conv(groups * len(plan), embed_dim, 1, dtype=dtype),
            FastBatchNorm(embed_dim, dtype=dtype))
        self.classifier = Dense(embed_dim, num_classes, dtype=dtype)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        s_list = []
        for block in self.feature:
            x, s = block(x)
            s_list.append(s)
        if self.loss == 'part_based':
            return x
        v_x = F.relu(self.fc_x(x.mean(dim=(2, 3), keepdim=True)))
        v_s = F.relu(self.fc_s(torch.cat(s_list, dim=1)))
        return classify(self, ((v_x + v_s) * 0.5)[:, :, 0, 0])


def mlfn(num_classes, loss='softmax', pretrained=True, dtype=torch.float32,
         **kwargs):
    return MLFN(num_classes, loss, dtype=dtype)
