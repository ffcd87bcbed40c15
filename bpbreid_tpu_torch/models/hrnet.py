"""HRNet-W32 backbone, eval path (port of bpbreid_tpu/models/hrnet.py).

Channel-first. Module names mirror the torch ``state_dict`` paths
(``stage3.1.branches.2.0.conv1``, ``stage3.1.fuse_layers.2.0.1.0``,
``transition2.2.0.0``, ``incre_modules.3.0.conv3``). The four branch
heads are upsampled (bilinear, align_corners=True) to 1/4 scale and
concatenated into the 1920-channel map. As in the JAX version the
upsample yields f32, so in bf16 mode the concat map is f32.

Calibrated int8 eval (JAX :85-108, :182, :196): the branch trunks and
``layer1`` produce ``QTensor`` outputs (``quant_out``); each branch output
and each stage input is a shared quantization point (``branch_amax_<j>``,
``<stage>_in_amax_<i>``) that the fuse convs, the identity term (through
``dequantize``), the transitions and the next blocks read.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (BasicBlock, Bottleneck,
                                             FastBatchNorm, PConv, ResLayer,
                                             calibrated_quant)
from bpbreid_tpu_torch.ops.quant import QTensor, dequantize, set_quant_paths
from bpbreid_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ['HighResolutionNet', 'hrnet32', 'HRNET_W32_STAGES']

# (num_modules, num_branches, num_blocks, channels) per stage
HRNET_W32_STAGES = {
    'stage2': (1, 2, (4, 4), (32, 64)),
    'stage3': (4, 3, (4, 4, 4), (32, 64, 128)),
    'stage4': (3, 4, (4, 4, 4, 4), (32, 64, 128, 256)),
}


class _ConvBNRelu(nn.Sequential):
    """``<name>.0`` conv, ``<name>.1`` BN, optional ReLU."""

    def __init__(self, cin, cout, kernel=3, stride=1, relu=True,
                 dtype=torch.float32):
        layers = [PConv(cin, cout, kernel, stride, kernel // 2, bias=False,
                        dtype=dtype),
                  FastBatchNorm(cout, dtype=dtype)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class HighResolutionModule(nn.Module):
    """Parallel branches + full cross-resolution fusion."""

    def __init__(self, num_branches, num_blocks, num_channels,
                 dtype=torch.float32):
        super().__init__()
        b = num_branches
        self.dtype = dtype
        # quant_out: every consumer of a branch output takes a QTensor
        # (the fuse convs, the identity's dequantize, the next stage's
        # transitions and blocks)
        self.branches = nn.ModuleList([
            ResLayer(BasicBlock, num_channels[i], num_channels[i],
                     num_blocks[i], quant_out=True, dtype=dtype)
            for i in range(b)])
        self.fuse_layers = None
        if b == 1:
            return
        fuse = []
        for i in range(b):
            row = []
            for j in range(b):
                if j == i:
                    row.append(None)
                elif j > i:
                    # 1x1 conv + BN, then nearest-upsample by 2^(j-i)
                    row.append(nn.Sequential(
                        PConv(num_channels[j], num_channels[i], 1,
                              bias=False, dtype=dtype),
                        FastBatchNorm(num_channels[i], dtype=dtype)))
                else:
                    # chain of stride-2 3x3 convs (relu between, none at end)
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        cout = num_channels[i] if last else num_channels[j]
                        chain.append(_ConvBNRelu(num_channels[j], cout, 3, 2,
                                                 relu=not last, dtype=dtype))
                    row.append(nn.Sequential(*chain))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        # int8: one shared s8 copy of each branch output
        xs = [calibrated_quant(self, x, name='branch_amax_{}'.format(j))
              for j, x in enumerate(xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = dequantize(xs[j], self.dtype) \
                        if isinstance(xs[j], QTensor) else xs[j]
                else:
                    t = layer(xs[j])
                    if j > i:
                        f = 2 ** (j - i)
                        t = t.repeat_interleave(f, dim=2) \
                             .repeat_interleave(f, dim=3)
                y = t if y is None else y + t
            outs.append(F.relu(y))
        return outs


class HighResolutionNet(nn.Module):
    """HRNet-W32 trunk emitting the 1/4-scale 1920-channel feature map.

    ``forward_branches`` returns the four per-branch head outputs
    (pre-upsample); ``concat`` builds the map from them. ``forward``
    returns the map, or ``(map, branches)`` with ``return_branches``.
    """

    def __init__(self, enable_dim_reduction=False, dim_reduction_channels=512,
                 return_branches=False, stages=None, dtype=torch.float32):
        super().__init__()
        self.stages = stages if stages is not None else HRNET_W32_STAGES
        self.enable_dim_reduction = enable_dim_reduction
        self.dim_reduction_channels = dim_reduction_channels
        self.return_branches = return_branches
        self.dtype = dtype
        self.conv1 = PConv(3, 64, 3, 2, 1, bias=False, dtype=dtype)
        self.bn1 = FastBatchNorm(64, dtype=dtype)
        self.conv2 = PConv(64, 64, 3, 2, 1, bias=False, dtype=dtype)
        self.bn2 = FastBatchNorm(64, dtype=dtype)
        # quant_out: layer1's output feeds the stage-2 transitions
        self.layer1 = ResLayer(Bottleneck, 64, 64, 4, quant_out=True,
                               dtype=dtype)

        prev = [256]
        for si, stage in enumerate(('stage2', 'stage3', 'stage4')):
            n_mod, n_br, n_blocks, channels = self.stages[stage]
            transition = []
            for i in range(n_br):
                if i < len(prev):
                    transition.append(
                        _ConvBNRelu(prev[i], channels[i], 3, 1, dtype=dtype)
                        if channels[i] != prev[i] else None)
                else:
                    # new branch: stride-2 conv chain from the lowest stream
                    chain = []
                    for j in range(i + 1 - len(prev)):
                        cout = channels[i] if j == i - len(prev) else prev[-1]
                        chain.append(_ConvBNRelu(prev[-1], cout, 3, 2,
                                                 dtype=dtype))
                    transition.append(nn.Sequential(*chain))
            setattr(self, 'transition{}'.format(si + 1),
                    nn.ModuleList(transition))
            setattr(self, stage, nn.ModuleList([
                HighResolutionModule(n_br, n_blocks, channels, dtype=dtype)
                for _ in range(n_mod)]))
            prev = list(channels)

        head_planes = self.stages['stage4'][3]
        self.incre_modules = nn.ModuleList([
            ResLayer(Bottleneck, head_planes[i], head_planes[i], 1,
                     dtype=dtype) for i in range(len(head_planes))])
        if enable_dim_reduction:
            self.cls_head = nn.Sequential(
                PConv(sum(4 * c for c in head_planes), dim_reduction_channels,
                      1, bias=True, dtype=dtype),
                FastBatchNorm(dim_reduction_channels, dtype=dtype),
                nn.ReLU())
        set_quant_paths(self)

    @property
    def feature_dim(self):
        if self.enable_dim_reduction:
            return self.dim_reduction_channels
        return sum(4 * c for c in self.stages['stage4'][3])

    def forward_branches(self, x):
        """``[N, 3, H, W]`` -> the four head outputs ``[N, 4c_i, H/4/2^i,
        W/4/2^i]``."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [x]
        for si, stage in enumerate(('stage2', 'stage3', 'stage4')):
            # int8: one shared s8 copy of each stage input, for its
            # transition convs and the blocks it passes through to
            xs = [calibrated_quant(self, x,
                                   name='{}_in_amax_{}'.format(stage, i))
                  for i, x in enumerate(xs)]
            transition = getattr(self, 'transition{}'.format(si + 1))
            new_xs = []
            for i, t in enumerate(transition):
                src = xs[i] if i < len(xs) else xs[-1]
                new_xs.append(src if t is None else t(src))
            xs = new_xs
            for module in getattr(self, stage):
                xs = module(xs)
        return [head(x) for head, x in zip(self.incre_modules, xs)]

    def concat(self, ys):
        """Upsample the branch heads to branch-0 resolution and concat
        (f32, as the JAX version's promotion gives)."""
        h, w = ys[0].shape[-2:]
        x = torch.cat([ys[0]] + [resize_bilinear_align_corners(y, h, w)
                                 for y in ys[1:]], dim=1)
        if self.enable_dim_reduction:
            x = self.cls_head(x)
        return x

    def forward(self, x):
        ys = self.forward_branches(x)
        feats = self.concat(ys)
        if self.return_branches:
            return feats, tuple(ys)
        return feats


def hrnet32(num_classes=1000, loss='part_based', pretrained=True,
            enable_dim_reduction=True, dim_reduction_channels=256,
            pretrained_path='', return_branches=False, stages=None,
            dtype=torch.float32, **kwargs):
    """Constructor mirroring bpbreid_tpu.models.hrnet.hrnet32. Weights
    are loaded separately (utils/weights.py)."""
    del num_classes, loss, pretrained, pretrained_path, kwargs
    return HighResolutionNet(enable_dim_reduction=enable_dim_reduction,
                             dim_reduction_channels=dim_reduction_channels,
                             return_branches=return_branches, stages=stages,
                             dtype=dtype)
