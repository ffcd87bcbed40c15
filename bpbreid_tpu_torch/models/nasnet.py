"""NASNet-A Mobile (port of bpbreid_tpu/models/nasnet.py).

Two stem cells, then three stages of a first cell and three normal cells
with a reduction cell between stages; separable-conv branches (depthwise
``k x k`` + pointwise), BN with eps 1e-3. Around some stride-2 branches
and pools the torch port pads one row and column of zeros at the top and
left and crops them after (``_max_pool_pad``, ``_avg_pool_pad``, the
``specific`` and ``reduction`` branches): the zeros take part in the max
and the average, which matters because the cells' inputs can be
negative. The cells' average pools leave their own padding out of the
count. The part-based call returns the 1056-channel map after the last
ReLU; the global head has a dropout of 0.5 whose keep-mask comes from
the generator ``set_dropout_generator`` gives it.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import (Dense, FastBatchNorm,
                                             GeneratorDropout)
from bpbreid_tpu_torch.models.zoo import avg_pool_excl, classify, conv

__all__ = ['NASNetAMobile', 'nasnetamobile']

NAS_BN_EPS = 1e-3


def _bn(c, dtype):
    return FastBatchNorm(c, eps=NAS_BN_EPS, dtype=dtype)


def _pad_tl(x):
    """``ZeroPad2d((1, 0, 1, 0))``: one zero row on top, one column left."""
    return F.pad(x, (1, 0, 1, 0))


def _max_pool(x):
    return F.max_pool2d(x, 3, 2, 1)


def _max_pool_pad(x):
    return _max_pool(_pad_tl(x))[:, :, 1:, 1:]


def _avg_pool_pad(x):
    return avg_pool_excl(_pad_tl(x), 3, 2, 1)[:, :, 1:, 1:]


class _Separable(nn.Module):
    """Depthwise ``k x k`` (``depthwise_conv2d``) + 1x1
    (``pointwise_conv2d``)."""

    def __init__(self, cin, cout, kernel, stride, dtype):
        super().__init__()
        self.depthwise_conv2d = conv(cin, cin, kernel, stride, groups=cin,
                                     dtype=dtype)
        self.pointwise_conv2d = conv(cin, cout, 1, dtype=dtype)

    def forward(self, x):
        return self.pointwise_conv2d(self.depthwise_conv2d(x))


class _Branch(nn.Module):
    """BranchSeparables and its stem / pad-and-crop variants (JAX
    ``_Branch`` :58): ReLU, separable (``kernel``, ``stride``), BN, ReLU,
    separable (stride 1), BN. ``mode``: 'plain', 'stem' (the first
    separable widens to ``cout``), 'specific' and 'reduction' (the first
    separable padded at the top and left and cropped)."""

    def __init__(self, cin, cout, kernel, stride, mode='plain',
                 dtype=torch.float32):
        super().__init__()
        self.pad_crop = mode in ('specific', 'reduction')
        mid = cout if mode == 'stem' else cin
        self.separable_1 = _Separable(cin, mid, kernel, stride, dtype)
        self.bn_sep_1 = _bn(mid, dtype)
        self.separable_2 = _Separable(mid, cout, kernel, 1, dtype)
        self.bn_sep_2 = _bn(cout, dtype)

    def forward(self, x):
        x = F.relu(x)
        if self.pad_crop:
            x = self.separable_1(_pad_tl(x))[:, :, 1:, 1:]
        else:
            x = self.separable_1(x)
        x = F.relu(self.bn_sep_1(x))
        return self.bn_sep_2(self.separable_2(x))


class _ReluConvBn(nn.Module):
    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.conv = conv(cin, cout, 1, dtype=dtype)
        self.bn = _bn(cout, dtype)

    def forward(self, x):
        return self.bn(self.conv(F.relu(x)))


class _Path(nn.Module):
    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.conv = conv(cin, cout, 1, dtype=dtype)


def _add_factorized_path(module, cin, half, dtype):
    """``path_1.conv``, ``path_2.conv`` and ``final_path_bn`` in
    ``module``'s own scope (JAX ``_factorized_path`` :130)."""
    module.path_1 = _Path(cin, half, dtype)
    module.path_2 = _Path(cin, half, dtype)
    module.final_path_bn = _bn(2 * half, dtype)


def _factorized_path(module, x_relu):
    """The stride-2 subsample through ``path_1`` and, shifted by a pixel
    (pad bottom and right, crop top and left), through ``path_2``;
    concatenated and normalized."""
    p1 = module.path_1.conv(x_relu[:, :, ::2, ::2])
    shifted = F.pad(x_relu, (0, 1, 0, 1))[:, :, 1:, 1:]
    p2 = module.path_2.conv(shifted[:, :, ::2, ::2])
    return module.final_path_bn(torch.cat([p1, p2], dim=1))


class CellStem0(nn.Module):
    """(JAX :148)"""

    def __init__(self, cin, nf, dtype=torch.float32):
        super().__init__()
        self.conv_1x1 = _ReluConvBn(cin, nf, dtype)
        self.comb_iter_0_left = _Branch(nf, nf, 5, 2, dtype=dtype)
        self.comb_iter_0_right = _Branch(cin, nf, 7, 2, 'stem', dtype)
        self.comb_iter_1_right = _Branch(cin, nf, 7, 2, 'stem', dtype)
        self.comb_iter_2_right = _Branch(cin, nf, 5, 2, 'stem', dtype)
        self.comb_iter_4_left = _Branch(nf, nf, 3, 1, dtype=dtype)

    def forward(self, x):
        x1 = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x1) + self.comb_iter_0_right(x)
        c1 = _max_pool(x1) + self.comb_iter_1_right(x)
        c2 = avg_pool_excl(x1, 3, 2, 1) + self.comb_iter_2_right(x)
        c3 = avg_pool_excl(c0) + c1
        c4 = self.comb_iter_4_left(c0) + _max_pool(x1)
        return torch.cat([c1, c2, c3, c4], dim=1)


class CellStem1(nn.Module):
    """(JAX :173)"""

    def __init__(self, cin_conv0, cin_stem0, nf, dtype=torch.float32):
        super().__init__()
        self.conv_1x1 = _ReluConvBn(cin_stem0, nf, dtype)
        _add_factorized_path(self, cin_conv0, nf // 2, dtype)
        for name, k, cin in (('comb_iter_0_left', 5, nf),
                             ('comb_iter_0_right', 7, 2 * (nf // 2)),
                             ('comb_iter_1_right', 7, 2 * (nf // 2)),
                             ('comb_iter_2_right', 5, 2 * (nf // 2))):
            setattr(self, name, _Branch(cin, nf, k, 2, 'specific', dtype))
        self.comb_iter_4_left = _Branch(nf, nf, 3, 1, 'specific', dtype)

    def forward(self, x_conv0, x_stem_0):
        x_left = self.conv_1x1(x_stem_0)
        x_right = _factorized_path(self, F.relu(x_conv0))
        c0 = self.comb_iter_0_left(x_left) + self.comb_iter_0_right(x_right)
        c1 = _max_pool_pad(x_left) + self.comb_iter_1_right(x_right)
        c2 = _avg_pool_pad(x_left) + self.comb_iter_2_right(x_right)
        c3 = avg_pool_excl(c0) + c1
        c4 = self.comb_iter_4_left(c0) + _max_pool_pad(x_left)
        return torch.cat([c1, c2, c3, c4], dim=1)


class _Cell(nn.Module):
    """FirstCell (``first``: the left input through the factorized path)
    and NormalCell (through ``conv_prev_1x1``) (JAX :199, :226).
    Returns ``[x_left, c0, ..., c4]`` concatenated."""

    def __init__(self, cin, cin_prev, out_left, out_right, first,
                 dtype=torch.float32):
        super().__init__()
        self.first = first
        if first:
            _add_factorized_path(self, cin_prev, out_left, dtype)
            left = 2 * out_left
        else:
            self.conv_prev_1x1 = _ReluConvBn(cin_prev, out_left, dtype)
            left = out_left
        r = out_right
        self.conv_1x1 = _ReluConvBn(cin, r, dtype)
        self.comb_iter_0_left = _Branch(r, r, 5, 1, dtype=dtype)
        # FirstCell's right branches are out_right wide, NormalCell's
        # out_left (the two are equal in every NASNet cell)
        w = r if first else out_left
        self.comb_iter_0_right = _Branch(left, w, 3, 1, dtype=dtype)
        self.comb_iter_1_left = _Branch(left, w, 5, 1, dtype=dtype)
        self.comb_iter_1_right = _Branch(left, w, 3, 1, dtype=dtype)
        self.comb_iter_4_left = _Branch(r, r, 3, 1, dtype=dtype)

    def forward(self, x, x_prev):
        if self.first:
            x_left = _factorized_path(self, F.relu(x_prev))
        else:
            x_left = self.conv_prev_1x1(x_prev)
        x_right = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x_right) + self.comb_iter_0_right(x_left)
        c1 = self.comb_iter_1_left(x_left) + self.comb_iter_1_right(x_left)
        c2 = avg_pool_excl(x_right) + x_left
        c3 = avg_pool_excl(x_left) + avg_pool_excl(x_left)
        c4 = self.comb_iter_4_left(x_right) + x_right
        return torch.cat([x_left, c0, c1, c2, c3, c4], dim=1)


class ReductionCell(nn.Module):
    """ReductionCell0 (``mode='reduction'``) and ReductionCell1
    (``'specific'``), one structure (JAX :252)."""

    def __init__(self, cin, cin_prev, out_left, out_right, mode='reduction',
                 dtype=torch.float32):
        super().__init__()
        r = out_right
        self.conv_prev_1x1 = _ReluConvBn(cin_prev, out_left, dtype)
        self.conv_1x1 = _ReluConvBn(cin, r, dtype)
        self.comb_iter_0_left = _Branch(r, r, 5, 2, mode, dtype)
        self.comb_iter_0_right = _Branch(out_left, r, 7, 2, mode, dtype)
        self.comb_iter_1_right = _Branch(out_left, r, 7, 2, mode, dtype)
        self.comb_iter_2_right = _Branch(out_left, r, 5, 2, mode, dtype)
        self.comb_iter_4_left = _Branch(r, r, 3, 1, mode, dtype)

    def forward(self, x, x_prev):
        x_left = self.conv_prev_1x1(x_prev)
        x_right = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x_right) + self.comb_iter_0_right(x_left)
        c1 = _max_pool_pad(x_right) + self.comb_iter_1_right(x_left)
        c2 = _avg_pool_pad(x_right) + self.comb_iter_2_right(x_left)
        c3 = avg_pool_excl(c0) + c1
        c4 = self.comb_iter_4_left(c0) + _max_pool_pad(x_right)
        return torch.cat([c1, c2, c3, c4], dim=1)


class NASNetAMobile(nn.Module):
    """(JAX :281)"""

    def __init__(self, num_classes, loss='softmax', stem_filters=32,
                 penultimate_filters=1056, filters_multiplier=2,
                 dtype=torch.float32):
        super().__init__()
        self.loss = loss
        f = penultimate_filters // 24
        m = filters_multiplier
        self.conv0 = nn.Module()
        self.conv0.conv = conv(3, stem_filters, 3, 2, padding=0, dtype=dtype)
        self.conv0.bn = _bn(stem_filters, dtype)
        self.cell_stem_0 = CellStem0(stem_filters, f // m ** 2, dtype)
        c_s0 = 4 * (f // m ** 2)
        self.cell_stem_1 = CellStem1(stem_filters, c_s0, f // m, dtype)
        c_s1 = 4 * (f // m)
        # (name, kind, out_left, out_right): each cell reads the last two
        # outputs
        plan = [('cell_0', 'first', f // 2, f), ('cell_1', 'normal', f, f),
                ('cell_2', 'normal', f, f), ('cell_3', 'normal', f, f),
                ('reduction_cell_0', 'reduction', 2 * f, 2 * f),
                ('cell_6', 'first', f, 2 * f),
                ('cell_7', 'normal', 2 * f, 2 * f),
                ('cell_8', 'normal', 2 * f, 2 * f),
                ('cell_9', 'normal', 2 * f, 2 * f),
                ('reduction_cell_1', 'specific', 4 * f, 4 * f),
                ('cell_12', 'first', 2 * f, 4 * f),
                ('cell_13', 'normal', 4 * f, 4 * f),
                ('cell_14', 'normal', 4 * f, 4 * f),
                ('cell_15', 'normal', 4 * f, 4 * f)]
        self.cell_names = [p[0] for p in plan]
        prev, cur = c_s0, c_s1
        for name, kind, left, right in plan:
            if kind in ('first', 'normal'):
                cell = _Cell(cur, prev, left, right, kind == 'first', dtype)
                out = (2 * left if kind == 'first' else left) + 5 * right
            else:
                cell = ReductionCell(cur, prev, left, right, kind, dtype)
                out = 4 * right
            setattr(self, name, cell)
            prev, cur = cur, out
        self.feature_dim = cur
        if loss != 'part_based':
            self.dropout = GeneratorDropout(0.5)
            self.classifier = Dense(cur, num_classes, dtype=dtype)

    def featuremaps(self, x):
        x_conv0 = self.conv0.bn(self.conv0.conv(x))
        x_stem_0 = self.cell_stem_0(x_conv0)
        prev, cur = x_stem_0, self.cell_stem_1(x_conv0, x_stem_0)
        for name in self.cell_names:
            prev, cur = cur, getattr(self, name)(cur, prev)
        return F.relu(cur)

    def forward(self, x):
        x = self.featuremaps(x)
        if self.loss == 'part_based':
            return x
        return classify(self, self.dropout(x.mean(dim=(2, 3))))


def nasnetamobile(num_classes, loss='softmax', pretrained=True,
                  dtype=torch.float32, **kwargs):
    return NASNetAMobile(num_classes, loss, dtype=dtype)
