"""Shared conv-net building blocks (port of bpbreid_tpu/models/common.py).

Channel-first (NCHW). Parameter and buffer names follow the reference
torch ``state_dict`` (``layer1.0.conv1.weight``, ``...bn1.running_mean``)
as the flax paths do. Parameters and BN statistics stay float32; each
module casts to its compute ``dtype`` where the JAX module does:

- ``PConv``/``Dense``: input and weight cast to ``dtype``, then the bias
  added in ``dtype`` (flax ``nn.Conv``/``nn.Dense``);
- ``FastBatchNorm``: normalize in f32, then cast to ``dtype`` (flax
  ``nn.BatchNorm`` and ``FastBatchNorm``), with the running statistics in
  eval mode and the batch statistics in train mode, where the per-channel
  sums of the forward and the backward are the K3 kernel
  (``ops/cuda/batchnorm.py``).
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_grad_stats, bn_stats,
                                                  channel_view)

__all__ = ['BN_EPS', 'BN_MOMENTUM', 'PConv', 'Dense', 'FastBatchNorm',
           'BasicBlock', 'Bottleneck', 'ResLayer', 'init_parameters']

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax: running = 0.9 * running + 0.1 * batch
# flax lecun_normal: truncated normal in [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class PConv(nn.Module):
    """Conv with explicit symmetric padding (flax ``PConv`` float path)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, groups=1, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.device.type == 'cpu' and self.dtype == torch.bfloat16:
            # torch's CPU bf16 convolution miscomputes some shapes (an
            # output one pixel wide gives NaN); an f32 conv of the bf16
            # operands rounded once is a bf16 conv with f32 accumulation
            y = F.conv2d(x.float(), w.float(), None, self.stride,
                         self.padding, 1, self.groups).to(self.dtype)
        else:
            y = F.conv2d(x, w, None, self.stride, self.padding, 1,
                         self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class Dense(nn.Module):
    """Linear layer over the last axis (flax ``nn.Dense`` semantics)."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class _BatchNormTrain(torch.autograd.Function):
    """Batch norm with batch statistics (``_bn_train`` :186, forward
    ``_bn_train_fwd_core`` :191, backward ``_bn_train_vjp_bwd`` :211).

    ``x`` is viewed as ``[A, C, B]`` (``channel_view``); ``m = A*B``:
    mean = sum(x)/m, var = max(0, sum(x^2)/m - mean^2) (the fast variance,
    clipped as in flax), y = (x - mean) * rstd * scale + bias in f32, cast
    to ``dtype``. Backward: dx = rstd*scale * (dy - sum(dy)/m
    - xhat * sum(dy*xhat)/m), dscale = sum(dy*xhat), dbias = sum(dy).
    The sums are ``bn_stats``/``bn_grad_stats``; mean and var are
    returned without gradient, for the running update.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, channel_dim, dtype):
        x = x.contiguous()
        a, c, b = channel_view(x.shape, channel_dim)
        m = a * b
        s1, s2 = bn_stats(x, channel_dim)
        mean = s1 / m
        var = torch.clamp(s2 / m - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = (x.view(a, c, b).float() - mean.view(1, c, 1)) \
            * (rstd * weight).view(1, c, 1)
        if bias is not None:
            y = y + bias.view(1, c, 1)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.channel_dim = channel_dim
        ctx.mark_non_differentiable(mean, var)
        return y.to(dtype).view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        a, c, b = channel_view(x.shape, ctx.channel_dim)
        m = a * b
        # autograd may hand over a strided gradient: the kernel reads a
        # contiguous one
        dy = dy.contiguous()
        sum_dy, sum_dy_xhat = bn_grad_stats(dy, x, mean, rstd,
                                            ctx.channel_dim)
        dx = None
        if ctx.needs_input_grad[0]:
            xhat = (x.view(a, c, b).float() - mean.view(1, c, 1)) \
                * rstd.view(1, c, 1)
            dx = (rstd * weight).view(1, c, 1) * (
                dy.view(a, c, b).float() - (sum_dy / m).view(1, c, 1)
                - xhat * (sum_dy_xhat / m).view(1, c, 1))
            dx = dx.to(x.dtype).view(x.shape)
        dbias = sum_dy if ctx.needs_input_grad[2] else None
        return dx, sum_dy_xhat, dbias, None, None, None


class FastBatchNorm(nn.Module):
    """Batch norm that normalizes in f32 and casts to ``dtype``.
    ``channel_dim`` is 1 for NCHW maps and -1 for feature-last
    embeddings (flax ``nn.BatchNorm`` on ``[N, D]`` and ``[N, K, D]``).

    Eval mode uses the running statistics. Train mode uses the batch
    statistics (``_BatchNormTrain``) and updates the running ones as
    flax does: ``0.9 * running + 0.1 * batch``, with the biased batch
    variance.
    """

    def __init__(self, num_features, eps=BN_EPS, bias=True, channel_dim=1,
                 dtype=torch.float32):
        super().__init__()
        self.eps, self.channel_dim, self.dtype = eps, channel_dim, dtype
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features)) if bias else None
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def _shape(self, x):
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        return shape

    def forward(self, x):
        if self.training:
            y, mean, var = _BatchNormTrain.apply(
                x, self.weight, self.bias, self.eps, self.channel_dim,
                self.dtype)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1.0 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1.0 - BN_MOMENTUM) * var)
            return y
        shape = self._shape(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(self.dtype)


def _conv_bn(cin, cout, kernel, stride, dtype):
    return nn.Sequential(
        PConv(cin, cout, kernel, stride, kernel // 2, bias=False, dtype=dtype),
        FastBatchNorm(cout, dtype=dtype))


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual (expansion 1)."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = PConv(inplanes, planes, 3, stride, 1, bias=False,
                           dtype=dtype)
        self.bn1 = FastBatchNorm(planes, dtype=dtype)
        self.conv2 = PConv(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = FastBatchNorm(planes, dtype=dtype)
        self.downsample = _conv_bn(inplanes, planes, 1, stride, dtype) \
            if has_downsample else None

    def forward(self, x):
        residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck + residual (expansion 4)."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = PConv(inplanes, planes, 1, 1, 0, bias=False, dtype=dtype)
        self.bn1 = FastBatchNorm(planes, dtype=dtype)
        self.conv2 = PConv(planes, planes, 3, stride, 1, bias=False,
                           dtype=dtype)
        self.bn2 = FastBatchNorm(planes, dtype=dtype)
        self.conv3 = PConv(planes, planes * 4, 1, 1, 0, bias=False,
                           dtype=dtype)
        self.bn3 = FastBatchNorm(planes * 4, dtype=dtype)
        self.downsample = _conv_bn(inplanes, planes * 4, 1, stride, dtype) \
            if has_downsample else None

    def forward(self, x):
        residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return F.relu(out + residual)


class ResLayer(nn.Sequential):
    """A stack of residual blocks named ``0``, ``1``, ... like the
    reference's ``nn.Sequential``."""

    def __init__(self, block, inplanes, planes, num_blocks, stride=1,
                 dtype=torch.float32):
        needs_ds = stride != 1 or inplanes != planes * block.expansion
        blocks = [block(inplanes, planes, stride, needs_ds, dtype=dtype)]
        blocks += [block(planes * block.expansion, planes, 1, False,
                         dtype=dtype) for _ in range(1, num_blocks)]
        super().__init__(*blocks)


def _lecun_normal_(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)


@torch.no_grad()
def init_parameters(module, generator):
    """Seeded init with the flax defaults: lecun-normal conv/dense
    kernels, zero biases, unit BN scales; BN running statistics reset to
    mean 0 / var 1. Visits modules in registration order, so the same
    generator state gives the same weights."""
    for m in module.modules():
        if isinstance(m, (PConv, Dense)):
            w = m.weight
            _lecun_normal_(w, w[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FastBatchNorm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
