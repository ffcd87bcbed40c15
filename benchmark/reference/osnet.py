"""Plain-PyTorch OSNet (Zhou et al., "Omni-Scale Feature Learning for
Person Re-Identification", ICCV 2019, arXiv:1905.00953) with its softmax
head, the reference of the ``osnet_x1_0`` configuration.

It imports nothing of the program under test and nothing of JAX. Module
and parameter names follow the torchreid ``state_dict`` that the program
mirrors (``conv2.0.conv2b.1.conv2.weight``, ``conv3.2.0.bn.running_var``,
``fc.1.weight``), so one seeded state dict loads into both sides. Its
layers are ``layers.py``'s: every convolution a ``Conv`` (the depthwise
3x3s with ``groups = C``), every batch norm a ``BN`` (the 80 of
OSNet x1.0, the fc's ``BatchNorm1d`` included), the fc and the classifier
``Linear``; float32 (the caller turns TF32 off), float8 operands under
``precision('fp8')``.

The network (torchreid ``models/osnet.py``): a 7x7 stride-2 stem and a
3x3 stride-2 max pool; three stages of two omni-scale blocks, the first
two stages ending in a transition (1x1 conv, 2x2 average pool); a 1x1
``conv5``; global average pooling, the fc (Linear, BN, ReLU) and the
classifier. A block: a 1x1 reduction to a quarter of its width, four
streams of 1 to 4 ``LightConv3x3`` (1x1 conv, depthwise 3x3, BN, ReLU)
each through one shared channel gate (global pool, 1x1 conv, ReLU, 1x1
conv, sigmoid) and summed, a 1x1 expansion with its BN (``conv3``), the
identity (a 1x1 conv and BN where the width changes) added, ReLU.

Departures from torchreid: the batch norms' running statistics move
with torch's momentum 0.1, which is flax's 0.9 / 0.1 in the program and
torchreid's own (only an eval forward reads them); the compute is float32
here and bfloat16 in the program (``model.compute_dtype``), where
torchreid trains in float32; the weights are seeded, with no ImageNet
checkpoint.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import BN, Conv, Linear
# label-smoothed cross entropy (torchreid's
# CrossEntropyLoss(label_smooth=True)), mean over the batch
from benchmark.reference.train import _smoothed_ce as smoothed_ce

__all__ = ['OSNet', 'build', 'state_shapes', 'counting_loss',
           'ends_residual', 'smoothed_ce']


class ConvBN(nn.Module):
    """A convolution (``conv``) and its batch norm (``bn``), ReLU unless
    ``relu`` is False: torchreid's ``ConvLayer``, ``Conv1x1`` and
    ``Conv1x1Linear``."""

    def __init__(self, cin, cout, k=1, stride=1, relu=True):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, k // 2)
        self.bn = BN(cout)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.relu else y


class LightConv3x3(nn.Module):
    """1x1 conv, depthwise 3x3 conv, BN, ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cout, 1)
        self.conv2 = Conv(cout, cout, 3, 1, 1, groups=cout)
        self.bn = BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        self.fc1 = Conv(c, c // reduction, 1, bias=True)
        self.fc2 = Conv(c // reduction, c, 1, bias=True)

    def forward(self, x):
        g = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(g)


class OSBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        mid = cout // 4
        self.conv1 = ConvBN(cin, mid)
        self.conv2a = LightConv3x3(mid, mid)
        self.conv2b = nn.Sequential(*(LightConv3x3(mid, mid)
                                      for _ in range(2)))
        self.conv2c = nn.Sequential(*(LightConv3x3(mid, mid)
                                      for _ in range(3)))
        self.conv2d = nn.Sequential(*(LightConv3x3(mid, mid)
                                      for _ in range(4)))
        self.gate = ChannelGate(mid)
        self.conv3 = ConvBN(mid, cout, relu=False)
        self.downsample = ConvBN(cin, cout, relu=False) \
            if cin != cout else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = sum(self.gate(stream(x1)) for stream in (
            self.conv2a, self.conv2b, self.conv2c, self.conv2d))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(x2) + identity)


class Transition(nn.Sequential):
    """1x1 conv, BN, ReLU (``<stage>.2.0``), then a 2x2 average pool."""

    def __init__(self, c):
        super().__init__(ConvBN(c, c), nn.AvgPool2d(2, 2))


class OSNet(nn.Module):
    def __init__(self, num_classes, channels=(64, 256, 384, 512),
                 fc_dim=512):
        super().__init__()
        self.conv1 = ConvBN(3, channels[0], 7, 2)
        for stage in range(3):
            cin, cout = channels[stage], channels[stage + 1]
            layers = [OSBlock(cin, cout), OSBlock(cout, cout)]
            if stage < 2:
                layers.append(Transition(cout))
            setattr(self, 'conv{}'.format(stage + 2), nn.Sequential(*layers))
        self.conv5 = ConvBN(channels[3], channels[3])
        self.fc = nn.Sequential(Linear(channels[3], fc_dim), BN(fc_dim),
                                nn.ReLU())
        self.classifier = Linear(fc_dim, num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        return self.classifier(self.fc(x.mean(dim=(2, 3))))


def build(config, device=None):
    """The reference model of a configuration (its ``model`` section:
    ``num_classes``, ``channels``, ``fc_dim``), on ``device``."""
    m = config['model']
    with torch.device(device or 'cpu'):
        return OSNet(m['num_classes'], tuple(m['channels']), m['fc_dim'])


def state_shapes(config):
    """``{name: shape}`` of the reference model's state dict, built on the
    meta device."""
    return {k: tuple(v.shape)
            for k, v in build(config, 'meta').state_dict().items()}


def counting_loss(config, out, n, device):
    """The train loss on the logits ``out`` for a batch of ``n``: the
    label-smoothed cross entropy on one identity (every batch norm is on
    its path)."""
    return smoothed_ce(out, torch.zeros(n, dtype=torch.int64, device=device),
                       config['loss']['eps'])


def ends_residual(name, shapes):
    """Whether ``name`` is the scale of a block's ``conv3`` batch norm,
    the last one before the residual sum."""
    del shapes
    return name.endswith('.conv3.bn.weight')
