"""HACNN, the Harmonious Attention CNN (port of
bpbreid_tpu/models/hacnn.py).

A global branch of Inception-A/B blocks, each followed by soft attention
(spatial: channel mean, a stride-2 conv, a 2x bilinear upsample with
``align_corners=True``, a 1x1 conv; channel: two 1x1 convs on the pooled
map; their product through a 1x1 conv and a sigmoid), and a local branch
(``learn_region``): the hard attention of each block gives four regions
(``tanh`` of a Dense, initialized to zero weights and torchreid's
biases), each sampled from the block's input by the spatial transformer
(``ops/grid_sample.py``), resized, added to the region's previous
features and refined by a shared Inception-B. The input is fixed at
160x64. Eval returns the L2-normalized global and local embeddings side
by side (the reference calls a ``Tensor.normalization`` torch lacks,
hacnn.py:391-392; JAX and the port normalize); train mode the two class
scores (``'softmax'``), with the two embeddings (``'triplet'``).
"""
import torch
import torch.nn as nn

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm
from bpbreid_tpu_torch.models.zoo import ConvBNReLU
from bpbreid_tpu_torch.ops.grid_sample import affine_grid_sample
from bpbreid_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ['InceptionA', 'InceptionB', 'SoftAttn', 'HardAttn', 'HACNN',
           'hacnn']

HACNN_INPUT = (160, 64)
# the hard attention's initial biases: four regions (tx, ty) (JAX :127)
HARD_ATTN_BIAS = (0.0, -0.75, 0.0, -0.25, 0.0, 0.25, 0.0, 0.75)


def _cb(cin, cout, kernel, stride=1, padding=0, dtype=torch.float32):
    """conv (with bias) + BN + ReLU (JAX ``ConvBlock``)."""
    return ConvBNReLU(cin, cout, kernel, stride, padding, bias=True,
                      dtype=dtype)


class InceptionA(nn.Module):
    """(JAX :40)"""

    def __init__(self, cin, out_channels, dtype=torch.float32):
        super().__init__()
        mid = out_channels // 4
        for i in range(1, 4):
            setattr(self, 'stream{}'.format(i), nn.Sequential(
                _cb(cin, mid, 1, dtype=dtype),
                _cb(mid, mid, 3, 1, 1, dtype)))
        self.stream4 = nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                     _cb(cin, mid, 1, dtype=dtype))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x),
                          self.stream3(x), self.stream4(x)], dim=1)


class InceptionB(nn.Module):
    """(JAX :61)"""

    def __init__(self, cin, out_channels, dtype=torch.float32):
        super().__init__()
        mid = out_channels // 4
        self.stream1 = nn.Sequential(_cb(cin, mid, 1, dtype=dtype),
                                     _cb(mid, mid, 3, 2, 1, dtype))
        self.stream2 = nn.Sequential(_cb(cin, mid, 1, dtype=dtype),
                                     _cb(mid, mid, 3, 1, 1, dtype),
                                     _cb(mid, mid, 3, 2, 1, dtype))
        self.stream3 = nn.Sequential(nn.MaxPool2d(3, 2, 1),
                                     _cb(cin, 2 * mid, 1, dtype=dtype))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x),
                          self.stream3(x)], dim=1)


class SoftAttn(nn.Module):
    """(JAX :81) The sigmoid is taken of the conv + BN + ReLU output, as in
    the reference."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.spatial_attn = nn.Module()
        self.spatial_attn.conv1 = _cb(1, 1, 3, 2, 1, dtype)
        self.spatial_attn.conv2 = _cb(1, 1, 1, dtype=dtype)
        self.channel_attn = nn.Module()
        self.channel_attn.conv1 = _cb(channels, channels // 16, 1,
                                      dtype=dtype)
        self.channel_attn.conv2 = _cb(channels // 16, channels, 1,
                                      dtype=dtype)
        self.conv = _cb(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        s = self.spatial_attn.conv1(x.mean(dim=1, keepdim=True))
        s = resize_bilinear_align_corners(s, s.shape[2] * 2, s.shape[3] * 2)
        s = self.spatial_attn.conv2(s)
        c = x.mean(dim=(2, 3), keepdim=True)
        c = self.channel_attn.conv2(self.channel_attn.conv1(c))
        return torch.sigmoid(self.conv(s * c))


class HardAttn(nn.Module):
    """``tanh(fc(mean(x)))`` as four ``(tx, ty)`` pairs (JAX :107)."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.fc = Dense(channels, 8, dtype=dtype)

    @torch.no_grad()
    def flax_init(self, generator):
        del generator
        self.fc.weight.zero_()
        self.fc.bias.copy_(torch.tensor(HARD_ATTN_BIAS))

    def forward(self, x):
        return torch.tanh(self.fc(x.mean(dim=(2, 3)))).reshape(-1, 4, 2)


class _HarmAttn(nn.Module):
    def __init__(self, channels, dtype):
        super().__init__()
        self.soft_attn = SoftAttn(channels, dtype)
        self.hard_attn = HardAttn(channels, dtype)


def _fc(cin, cout, dtype):
    return nn.Sequential(Dense(cin, cout, dtype=dtype),
                         FastBatchNorm(cout, channel_dim=-1, dtype=dtype),
                         nn.ReLU())


def _l2_normalize(v):
    return v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)


class HACNN(nn.Module):
    """(JAX :122)"""

    def __init__(self, num_classes, loss='softmax', nchannels=(128, 256, 384),
                 feat_dim_stream=512, learn_region=True, dtype=torch.float32):
        super().__init__()
        self.loss, self.learn_region = loss, learn_region
        self.conv = _cb(3, 32, 3, 2, 1, dtype)
        cin = 32
        for b, c in enumerate(nchannels):
            setattr(self, 'inception{}'.format(b + 1), nn.Sequential(
                InceptionA(cin, c, dtype), InceptionB(c, c, dtype)))
            setattr(self, 'ha{}'.format(b + 1), _HarmAttn(c, dtype))
            if learn_region:
                setattr(self, 'local_conv{}'.format(b + 1),
                        InceptionB(cin, c, dtype))
            cin = c
        self.fc_global = _fc(nchannels[-1], feat_dim_stream, dtype)
        self.classifier_global = Dense(feat_dim_stream, num_classes,
                                       dtype=dtype)
        if learn_region:
            self.fc_local = _fc(4 * nchannels[-1], feat_dim_stream, dtype)
            self.classifier_local = Dense(feat_dim_stream, num_classes,
                                          dtype=dtype)
        self.feature_dim = feat_dim_stream * (2 if learn_region else 1)
        self.n_blocks = len(nchannels)

    @staticmethod
    def _stn_region(x, theta_i):
        """theta ``[[1, 0, tx], [0, 0.25, ty]]`` and the sample (JAX
        :139)."""
        n = theta_i.shape[0]
        one, zero = theta_i.new_ones(n), theta_i.new_zeros(n)
        theta = torch.stack([
            torch.stack([one, zero, theta_i[:, 0]], dim=1),
            torch.stack([zero, one * 0.25, theta_i[:, 1]], dim=1)], dim=1)
        return affine_grid_sample(x, theta)

    def forward(self, x):
        if tuple(x.shape[2:]) != HACNN_INPUT:
            raise ValueError('HACNN expects 160x64 input, got {}x{}'.format(
                x.shape[2], x.shape[3]))
        cur = self.conv(x)
        local_sizes = ((24, 28), (12, 14), (6, 7))
        x_locals = [None] * 4
        for b in range(1, self.n_blocks + 1):
            inc = getattr(self, 'inception{}'.format(b))(cur)
            ha = getattr(self, 'ha{}'.format(b))
            out = inc * ha.soft_attn(inc)
            if self.learn_region:
                theta = ha.hard_attn(inc)
                local_conv = getattr(self, 'local_conv{}'.format(b))
                lh, lw = local_sizes[b - 1]
                new_locals = []
                for r in range(4):
                    trans = resize_bilinear_align_corners(
                        self._stn_region(cur, theta[:, r]), lh, lw)
                    if b > 1:
                        trans = trans + x_locals[r]
                    new_locals.append(local_conv(trans))
                x_locals = new_locals
            cur = out
        x_global = self.fc_global(cur.mean(dim=(2, 3)))
        if self.learn_region:
            x_local = self.fc_local(torch.cat(
                [li.mean(dim=(2, 3)) for li in x_locals], dim=1))
        if not self.training:
            if self.learn_region:
                return torch.cat([_l2_normalize(x_global),
                                  _l2_normalize(x_local)], dim=1)
            return x_global
        y_global = self.classifier_global(x_global)
        if self.learn_region:
            y_local = self.classifier_local(x_local)
        if self.loss == 'softmax':
            return (y_global, y_local) if self.learn_region else y_global
        if self.loss == 'triplet':
            if self.learn_region:
                return (y_global, y_local), (x_global, x_local)
            return y_global, x_global
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def hacnn(num_classes, loss='softmax', pretrained=True, dtype=torch.float32,
          **kwargs):
    return HACNN(num_classes, loss, dtype=dtype)
