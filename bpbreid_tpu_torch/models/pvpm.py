"""PVPM, pose-guided visible part matching (port of
bpbreid_tpu/models/pvpm.py).

PCB's ResNet-50 trunk (last stride 1) whose part features are pooled
under pose-guided attention maps. A pose subnet (``pose_subnet``: the
port's OSNet ``ConvLayer``, ``OSBlock`` and ``Conv1x1``) turns external
pose heatmaps ``[N, 56, 4 Hf, 4 Wf]`` into ``P`` sigmoid attention maps
at the trunk's ``[Hf, Wf]``; each pixel keeps the map of its argmax part
(a one-hot, first index on ties) and each part's feature is the map's
mean of ``f * att_p / (mean(att_p) + 1e-6)``. Eval returns the parts'
features ``[N, 2048, P]`` L2-normalized over the channels and flattened
channel-major (and the part scores with ``part_score_reg``); train mode
a 1x1 conv + BN + ReLU (``em.<p>``) and a classifier per part.

``forward(x, pose_map)``: no data manager or engine of the JAX package
gives pose maps, so the model is held at the module level only.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm, PConv
from bpbreid_tpu_torch.models.osnet import Conv1x1, ConvLayer, OSBlock
from bpbreid_tpu_torch.models.pcb import (add_resnet50_trunk,
                                          run_resnet50_trunk)

__all__ = ['PoseSubnet', 'PoseGuidedAttResnet', 'pose_p4', 'pose_p6',
           'pose_p4s', 'pose_p6s']


class _ConvBN(nn.Module):
    """A bias-free conv (``conv``) and its BN (``bn``)."""

    def __init__(self, cin, cout, kernel, dtype):
        super().__init__()
        self.conv = PConv(cin, cout, kernel, 1, kernel // 2, bias=False,
                          dtype=dtype, quant=False)
        self.bn = FastBatchNorm(cout, dtype=dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class _ScoreReg(nn.Module):
    """The part-score regression: Dense (``reg``) + BN1d (``bn``)."""

    def __init__(self, cin, parts, dtype):
        super().__init__()
        self.reg = Dense(cin, parts, bias=False, dtype=dtype)
        self.bn = FastBatchNorm(parts, channel_dim=-1, dtype=dtype)

    def forward(self, x):
        return self.bn(self.reg(x))


class PoseSubnet(nn.Module):
    """The PVP + PGA subnet over pose heatmaps (JAX :28). Returns
    ``(att, onehot)``, or ``(att, part_scores, onehot)`` with
    ``matching_score_reg``; ``att`` and ``onehot`` ``[N, P, H, W]``."""

    def __init__(self, att_num, channels=(32, 32, 32), pose_inchannel=56,
                 matching_score_reg=False, dtype=torch.float32):
        super().__init__()
        ch = channels
        self.att_num = att_num
        self.conv1 = ConvLayer(pose_inchannel, ch[0], 7, 1, dtype=dtype)
        self.conv2 = nn.Sequential(
            OSBlock(ch[0], ch[1], dtype=dtype),
            nn.Sequential(Conv1x1(ch[1], ch[1], dtype=dtype),
                          nn.AvgPool2d(2, 2)))
        self.conv3 = nn.Sequential(OSBlock(ch[1], ch[2], dtype=dtype))
        self.conv4 = _ConvBN(ch[2], ch[2], 3, dtype)
        self.conv_out = _ConvBN(ch[2], att_num, 1, dtype)
        self.conv_score = _ScoreReg(ch[2], att_num, dtype) \
            if matching_score_reg else None

    def forward(self, pose_map):
        x = F.max_pool2d(self.conv1(pose_map), 3, 2, 1)
        x = self.conv3(self.conv2(x))
        x_ = F.relu(self.conv4(x))
        att = torch.sigmoid(self.conv_out(x_))
        onehot = F.one_hot(att.argmax(dim=1), self.att_num) \
            .permute(0, 3, 1, 2).to(att.dtype)
        if self.conv_score is not None:
            s = torch.sigmoid(self.conv_score(x_.mean(dim=(2, 3))))
            return att, s, onehot
        return att, onehot


class PoseGuidedAttResnet(nn.Module):
    """(JAX :68) Train mode returns ``(scores, att)`` (``'softmax'``; with
    ``part_score_reg`` ``(scores, att, part_scores, part_features)``) or
    ``(scores, embeddings)`` (``'triplet'``), each of the first a list of
    ``P``."""

    def __init__(self, num_classes, loss='softmax', parts=4, reduced_dim=256,
                 part_score_reg=False, pose_inchannel=56,
                 dtype=torch.float32):
        super().__init__()
        self.loss, self.parts = loss, parts
        self.part_score_reg = part_score_reg
        self.feature_dim = reduced_dim
        add_resnet50_trunk(self, dtype)
        self.pose_subnet = PoseSubnet(parts, pose_inchannel=pose_inchannel,
                                      matching_score_reg=part_score_reg,
                                      dtype=dtype)
        self.em = nn.ModuleList(nn.Sequential(
            PConv(2048, reduced_dim, 1, bias=True, dtype=dtype, quant=False),
            FastBatchNorm(reduced_dim, dtype=dtype)) for _ in range(parts))
        self.classifier = nn.ModuleList(
            Dense(reduced_dim, num_classes, bias=False, dtype=dtype)
            for _ in range(parts))

    def forward(self, x, pose_map):
        f = run_resnet50_trunk(self, x)                 # [N, 2048, Hf, Wf]
        if self.part_score_reg:
            pose_att, part_score, onehot = self.pose_subnet(pose_map)
        else:
            (pose_att, onehot), part_score = self.pose_subnet(pose_map), None
        pose_att = pose_att * onehot                    # [N, P, Hf, Wf]
        att_mean = pose_att.mean(dim=(2, 3))            # [N, P]
        v_parts = []
        for i in range(self.parts):
            w = pose_att[:, i:i + 1] / (att_mean[:, i, None, None, None]
                                        + 1e-6)
            v_parts.append((f * w).mean(dim=(2, 3)))    # [N, 2048]
        if not self.training:
            vg = torch.stack(v_parts, dim=-1)           # [N, 2048, P]
            vg = vg / vg.norm(dim=1, keepdim=True).clamp_min(1e-12)
            flat = vg.reshape(vg.shape[0], -1)
            return (flat, part_score) if self.part_score_reg else flat
        vs = [F.relu(em(v[:, :, None, None]))[:, :, 0, 0]
              for em, v in zip(self.em, v_parts)]
        ys = [cls(v) for cls, v in zip(self.classifier, vs)]
        if self.loss == 'softmax':
            if self.part_score_reg:
                return ys, pose_att, part_score, v_parts
            return ys, pose_att
        if self.loss == 'triplet':
            return ys, vs
        raise KeyError('Unsupported loss: {}'.format(self.loss))


def _pvpm(parts, num_classes, loss, part_score_reg=False,
          dtype=torch.float32, **kwargs):
    return PoseGuidedAttResnet(num_classes, loss, parts=parts,
                               part_score_reg=part_score_reg, dtype=dtype)


def pose_p4(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _pvpm(4, num_classes, loss, **kwargs)


def pose_p6(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _pvpm(6, num_classes, loss, **kwargs)


def pose_p4s(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _pvpm(4, num_classes, loss, part_score_reg=True, **kwargs)


def pose_p6s(num_classes, loss='softmax', pretrained=True, **kwargs):
    return _pvpm(6, num_classes, loss, part_score_reg=True, **kwargs)
