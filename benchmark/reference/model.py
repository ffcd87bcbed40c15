"""Plain-PyTorch BPBReID (Somers et al., WACV 2023) on HRNet-W32 or a
torchvision-style ResNet, the benchmark's reference model.

It imports nothing of the program under test. Module and parameter names
follow the torchreid ``state_dict`` that the program mirrors
(``backbone_appearance_feature_extractor.stage3.1.branches.2.0.conv1``,
``parts_identity_classifier.3.bn``), so one seeded state dict loads into
both sides.

It is the default reference of a configuration (``"reference"``
absent or ``"model"``; ``benchmark/reference/__init__.py`` states what a
reference module gives). Its layers are ``layers.py``'s: float32 through
``F.conv2d``, ``F.linear`` and ``F.batch_norm`` (the caller turns TF32
off), and float8 operands under ``precision('fp8')``, the
lower-precision control that the comparison has to reject.

Departures from the published model and configs
(github.com/VlSomers/bpbreid ``configs/bpbreid/bpbreid_market1501_*.yaml``):

- only the shipped options: GWAP parts pooling, learnable attention,
  ``dim_reduce: after_pooling``, binary visibility, no test-time target
  segmentation;
- the pooling always runs on the materialized map (HRNet: the four
  branch heads upsampled to 1/4 scale and concatenated, 1920 channels);
- the upsampling in HRNet's fuse layers is nearest, the concat's is
  bilinear with ``align_corners=True``, as in the reference code;
- the foreground visibility in binary mode is ``any`` over all K+1
  argmax channels (always true), as the reference code computes it.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import train as ref_train
# the shared layers, re-exported under their old names
from benchmark.reference.layers import (  # noqa: F401
    BN, PRECISION, Conv, Linear, _product, conv2d, linear, precision)

__all__ = ['BPBReID', 'BN', 'Conv', 'Linear', 'PRECISION', 'build',
           'conv2d', 'counting_loss', 'feature_map', 'linear', 'precision',
           'state_shapes', 'HRNET_W32_STAGES']

HRNET_W32_STAGES = {
    'stage2': (1, 2, (4, 4), (32, 64)),
    'stage3': (4, 3, (4, 4, 4), (32, 64, 128)),
    'stage4': (3, 4, (4, 4, 4, 4), (32, 64, 128, 256)),
}
RESNET_LAYERS = {'resnet18': ('basic', (2, 2, 2, 2)),
                 'resnet50': ('bottleneck', (3, 4, 6, 3))}


def _conv_bn(cin, cout, k, stride):
    return nn.Sequential(Conv(cin, cout, k, stride, k // 2), BN(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1)
        self.bn1 = BN(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.bn2 = BN(planes)
        self.downsample = _conv_bn(cin, planes, 1, stride) if downsample \
            else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = BN(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1)
        self.bn2 = BN(planes)
        self.conv3 = Conv(planes, planes * 4, 1)
        self.bn3 = BN(planes * 4)
        self.downsample = _conv_bn(cin, planes * 4, 1, stride) \
            if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


def _layer(block, cin, planes, n, stride=1):
    ds = stride != 1 or cin != planes * block.expansion
    blocks = [block(cin, planes, stride, ds)]
    blocks += [block(planes * block.expansion, planes)
               for _ in range(1, n)]
    return nn.Sequential(*blocks)


def _conv_bn_relu(cin, cout, stride, relu=True):
    layers = [Conv(cin, cout, 3, stride, 1), BN(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class HRModule(nn.Module):
    def __init__(self, blocks, channels):
        super().__init__()
        b = len(channels)
        self.branches = nn.ModuleList([
            _layer(BasicBlock, channels[i], channels[i], blocks[i])
            for i in range(b)])
        self.fuse_layers = None
        if b == 1:
            return
        rows = []
        for i in range(b):
            row = []
            for j in range(b):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(nn.Sequential(Conv(channels[j], channels[i], 1),
                                             BN(channels[i])))
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn_relu(channels[j],
                                      channels[i] if k == i - j - 1
                                      else channels[j], 2,
                                      relu=k != i - j - 1)
                        for k in range(i - j)]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = 0
            for j, layer in enumerate(row):
                if j == i:
                    t = xs[j]
                else:
                    t = layer(xs[j])
                    if j > i:
                        t = F.interpolate(t, scale_factor=2 ** (j - i),
                                          mode='nearest')
                y = y + t
            outs.append(F.relu(y))
        return outs


class HRNet(nn.Module):
    """HRNet-W32 (Wang et al., TPAMI 2020) with the classification
    heads' increment blocks; returns the 1920-channel 1/4-scale map."""

    def __init__(self, stages=HRNET_W32_STAGES):
        super().__init__()
        self.stage_specs = stages
        self.conv1 = Conv(3, 64, 3, 2, 1)
        self.bn1 = BN(64)
        self.conv2 = Conv(64, 64, 3, 2, 1)
        self.bn2 = BN(64)
        self.layer1 = _layer(Bottleneck, 64, 64, 4)
        prev = [256]
        for si, name in enumerate(('stage2', 'stage3', 'stage4')):
            n_mod, n_br, blocks, channels = stages[name]
            trans = []
            for i in range(n_br):
                if i < len(prev):
                    trans.append(_conv_bn_relu(prev[i], channels[i], 1)
                                 if channels[i] != prev[i] else None)
                else:
                    trans.append(nn.Sequential(*[
                        _conv_bn_relu(prev[-1], channels[i]
                                      if j == i - len(prev) else prev[-1], 2)
                        for j in range(i + 1 - len(prev))]))
            setattr(self, 'transition{}'.format(si + 1), nn.ModuleList(trans))
            setattr(self, name, nn.ModuleList(
                [HRModule(blocks, channels) for _ in range(n_mod)]))
            prev = list(channels)
        self.incre_modules = nn.ModuleList(
            [_layer(Bottleneck, c, c, 1) for c in prev])
        self.feature_dim = sum(4 * c for c in prev)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for si, name in enumerate(('stage2', 'stage3', 'stage4')):
            trans = getattr(self, 'transition{}'.format(si + 1))
            xs = [(xs[i] if i < len(xs) else xs[-1]) if t is None
                  else t(xs[i] if i < len(xs) else xs[-1])
                  for i, t in enumerate(trans)]
            for module in getattr(self, name):
                xs = module(xs)
        ys = [head(x) for head, x in zip(self.incre_modules, xs)]
        h, w = ys[0].shape[-2:]
        return torch.cat([ys[0]] + [
            F.interpolate(y, size=(h, w), mode='bilinear', align_corners=True)
            for y in ys[1:]], dim=1)


class ResNet(nn.Module):
    """torchvision ResNet trunk (He et al., CVPR 2016) with the re-id last
    stride; returns the last stage's map."""

    def __init__(self, name='resnet50', last_stride=1):
        super().__init__()
        kind, layers = RESNET_LAYERS[name]
        block = Bottleneck if kind == 'bottleneck' else BasicBlock
        self.conv1 = Conv(3, 64, 7, 2, 3)
        self.bn1 = BN(64)
        cin = 64
        for i, (planes, stride) in enumerate(zip((64, 128, 256, 512),
                                                 (1, 2, 2, last_stride))):
            setattr(self, 'layer{}'.format(i + 1),
                    _layer(block, cin, planes, layers[i], stride))
            cin = planes * block.expansion
        self.feature_dim = cin

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, 'layer{}'.format(i))(x)
        return x


class DimReduce(nn.Module):
    """Linear + BN + ReLU over the last axis (``layers.0``, ``layers.1``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.layers = nn.ModuleList([Linear(cin, cout), BN(cout), nn.ReLU()])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class BNClassifier(nn.Module):
    """BNNeck: a batch norm without bias, then a linear classifier without
    bias."""

    def __init__(self, d, num_classes):
        super().__init__()
        self.bn = BN(d, bias=False)
        self.classifier = Linear(d, num_classes, bias=False)

    def forward(self, x):
        f = self.bn(x)
        return f, self.classifier(f)


class PixelClassifier(nn.Module):
    def __init__(self, d, parts_num):
        super().__init__()
        self.bn = BN(d)
        self.classifier = Conv(d, parts_num + 1, 1, bias=True)

    def forward(self, x):
        return self.classifier(self.bn(x))


class BPBReID(nn.Module):
    """Backbone map -> pixel-to-part attention -> GAP/GWAP pooling of the
    global, foreground, background and part streams -> after-pooling dim
    reduction -> BNNeck identity classifiers."""

    def __init__(self, num_classes, parts_num, backbone='hrnet32',
                 dim_reduce_output=512, last_stride=1):
        super().__init__()
        self.parts_num = parts_num
        trunk = HRNet() if backbone == 'hrnet32' \
            else ResNet(backbone, last_stride)
        self.backbone_appearance_feature_extractor = trunk
        d, out = trunk.feature_dim, dim_reduce_output
        for stream in ('global', 'foreground', 'background', 'parts'):
            setattr(self, '{}_after_pooling_dim_reduce'.format(stream),
                    DimReduce(d, out))
        self.pixel_classifier = PixelClassifier(d, parts_num)
        for name in ('global', 'background', 'foreground'):
            setattr(self, '{}_identity_classifier'.format(name),
                    BNClassifier(out, num_classes))
        self.concat_parts_identity_classifier = BNClassifier(
            out * parts_num, num_classes)
        self.parts_identity_classifier = nn.ModuleList(
            [BNClassifier(out, num_classes) for _ in range(parts_num)])

    def forward(self, images):
        """``images`` ``[N, 3, H, W]`` normalized. Returns a dict:
        ``emb`` (stream -> embedding), ``scores`` (stream -> identity
        logits), ``pixel_logits`` ``[N, K+1, Hf, Wf]``, ``visibility``
        (stream -> ``[N]`` or ``[N, K]`` bool)."""
        k = self.parts_num
        f = self.backbone_appearance_feature_extractor(images)
        n, d, hf, wf = f.shape
        logits = self.pixel_classifier(f)
        probs = torch.softmax(logits, dim=1)
        background, parts = probs[:, 0], probs[:, 1:]
        foreground = parts.amax(dim=1)
        pred = probs.argmax(dim=1).reshape(n, -1)
        vis = (pred[:, None, :] == torch.arange(
            k + 1, device=pred.device)[None, :, None]).any(dim=-1)
        flat = f.reshape(n, d, hf * wf)
        area = float(hf * wf)
        glob = flat.mean(dim=-1)
        fg = torch.einsum('np,ndp->nd', foreground.reshape(n, -1), flat) / area
        bg = torch.einsum('np,ndp->nd', background.reshape(n, -1), flat) / area
        pm = parts.reshape(n, k, -1)
        pt = torch.einsum('nkp,ndp->nkd', pm, flat) \
            / pm.sum(dim=-1).clamp(min=1e-6)[..., None]
        glob = self.global_after_pooling_dim_reduce(glob)
        fg = self.foreground_after_pooling_dim_reduce(fg)
        bg = self.background_after_pooling_dim_reduce(bg)
        pt = self.parts_after_pooling_dim_reduce(pt)
        conct = pt.reshape(n, -1)
        emb = {'globl': glob, 'foreg': fg, 'backg': bg, 'conct': conct,
               'parts': pt}
        scores = {}
        for key, clf in (('globl', self.global_identity_classifier),
                         ('foreg', self.foreground_identity_classifier),
                         ('backg', self.background_identity_classifier),
                         ('conct', self.concat_parts_identity_classifier)):
            emb['bn_' + key], scores[key] = clf(emb[key])
        outs = [clf(pt[:, i]) for i, clf in
                enumerate(self.parts_identity_classifier)]
        emb['bn_parts'] = torch.stack([o[0] for o in outs], dim=1)
        scores['parts'] = torch.stack([o[1] for o in outs], dim=1)
        visibility = {'foreg': vis.any(dim=1), 'parts': vis[:, 1:],
                      'backg': vis[:, 0]}
        return {'emb': emb, 'scores': scores, 'pixel_logits': logits,
                'visibility': visibility}


def build(config, device=None):
    """The reference model of a benchmark configuration (its ``model``
    section), on ``device``."""
    m = config['model']
    with torch.device(device or 'cpu'):
        return BPBReID(m['num_classes'], m['parts_num'], m['backbone'],
                       m['dim_reduce_output'], m.get('last_stride', 1))


def feature_map(model):
    """The module whose output is the map the parts are pooled from."""
    return model.backbone_appearance_feature_extractor


def counting_loss(config, out, n, device):
    """The train loss on the forward's ``out`` for a batch of ``n``, whose
    gradient says which batch norms the backward reaches: GiLt and the
    pixel loss on all-background masks and one identity."""
    m = config['model']
    s = config['masks']['mask_scale']
    masks = torch.zeros(n, m['parts_num'] + 1, m['height'] // s,
                        m['width'] // s, device=device)
    pids = torch.zeros(n, dtype=torch.int64, device=device)
    loss, _ = ref_train.gilt_loss(out, masks, pids,
                                  config['loss']['weights'],
                                  config['loss']['margin'])
    return loss


def state_shapes(config):
    """``{name: shape}`` of the reference model's state dict, built on the
    meta device."""
    return {k: tuple(v.shape)
            for k, v in build(config, 'meta').state_dict().items()}
