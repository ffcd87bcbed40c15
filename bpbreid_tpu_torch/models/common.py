"""Shared conv-net building blocks (port of bpbreid_tpu/models/common.py).

Channel-first (NCHW). Parameter and buffer names follow the reference
torch ``state_dict`` (``layer1.0.conv1.weight``, ``...bn1.running_mean``)
as the flax paths do. Parameters and BN statistics stay float32; each
module casts to its compute ``dtype`` where the JAX module does:

- ``PConv``/``Dense``: input and weight cast to ``dtype``, then the bias
  added in ``dtype`` (flax ``nn.Conv``/``nn.Dense``);
- ``FastBatchNorm``: normalize in f32, then cast to ``dtype`` (flax
  ``nn.BatchNorm`` and ``FastBatchNorm``), with the running statistics in
  eval mode and the batch statistics in train mode. On the card it is the
  BN kernels of ``ops/cuda/batchnorm.py`` and nothing else: in train mode
  ``bn_stats`` (K3a) and ``bn_apply`` forward, ``bn_grad_stats`` (K3b) and
  ``bn_dx`` backward; in eval mode ``bn_apply``.

Calibrated int8 eval (``ops/quant.py``, JAX :29-139): inside
``int8_calibration`` every ``PConv`` records the range of its input
(``act_amax``) and the blocks the ranges of their shared quantization
points (``in_amax``, ``out_amax`` with ``quant_out``); inside
``int8_inference`` a ``PConv`` that is not skipped runs ``quant_conv``
(``conv_s8`` on the card), on the shared ``QTensor`` it is given or on
its own static quantize, with a dynamic scale where it was never
calibrated. The residual reads a shared copy through ``dequantize``.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.cuda.batchnorm import MOMENTUM as BN_MOMENTUM
from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_apply, bn_apply_sums,
                                                  bn_dx, bn_grad_local_sums,
                                                  bn_grad_stats,
                                                  bn_local_sums, bn_stats,
                                                  channel_view)
from bpbreid_tpu_torch.ops.quant import (QTensor, QuantWeightCache,
                                         act_scale_from_amax, calibrated_scale,
                                         dequantize, quant_conv, quant_mode,
                                         quant_shared_points, quant_skipped,
                                         quantize_calibrated, record_amax,
                                         set_quant_paths)
from bpbreid_tpu_torch.parallel.mesh import all_reduce

__all__ = ['BN_EPS', 'BN_MOMENTUM', 'PConv', 'Dense', 'FastBatchNorm',
           'InstanceNorm', 'GeneratorDropout', 'set_dropout_generator',
           'BasicBlock', 'Bottleneck', 'ResLayer', 'calibrated_quant',
           'init_parameters']

BN_EPS = 1e-5
# flax lecun_normal: truncated normal in [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class PConv(nn.Module):
    """Conv with explicit symmetric padding (flax ``PConv``), with the
    calibrate and int8 modes of ``ops/quant.py`` (JAX :29-113).

    ``quant=False`` marks a conv that is a flax ``nn.Conv`` in JAX (the
    ResNet stem, the before-pooling reduction, the pixel classifier): it
    stays float in every mode and records nothing. ``kernel_size`` and
    ``padding`` may be ``(h, w)`` pairs (the zoo's 1x7 and 7x1 convs,
    which are all ``quant=False``). The quantized weights
    are kept between calls (``quant_cache``, keyed on the weight's storage
    and version, so a device move or a load recomputes them).
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, groups=1, dtype=torch.float32,
                 quant=True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.quant = quant
        self.quant_path = ''
        self.quant_cache = QuantWeightCache()
        kh, kw = (kernel_size, kernel_size) \
            if isinstance(kernel_size, int) else kernel_size
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def _load_from_state_dict(self, *args, **kwargs):
        self.quant_cache.clear()
        super()._load_from_state_dict(*args, **kwargs)

    def forward(self, x):
        mode = quant_mode() if self.quant else 'off'
        if mode == 'calibrate':
            record_amax(self, 'act_amax', x)
        skipped = mode == 'int8' and quant_skipped(self.quant_path)
        if skipped and isinstance(x, QTensor):
            x = dequantize(x, self.dtype)
        if isinstance(x, QTensor):
            # quantized by the enclosing block or module (one s8 copy
            # shared by every consumer): the scale travels with it
            return quant_conv(x, self.weight, self.stride, self.padding,
                              groups=self.groups, out_dtype=self.dtype,
                              bias=self.bias, cache=self.quant_cache)
        if mode == 'int8' and not skipped:
            if 'act_amax' in self._buffers:
                scale, key = calibrated_scale(self, 'act_amax')
            else:
                # uncalibrated: a dynamic scale at the same granularity
                scale, key = act_scale_from_amax(
                    x.float().abs().amax(dim=(0, 2, 3))), None
            return quant_conv(x, self.weight, self.stride, self.padding,
                              scale, self.groups, self.dtype, self.bias,
                              self.quant_cache, key)
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


def calibrated_quant(module, x, name='in_amax'):
    """Module-level quantization point for a hot tensor (JAX :116).

    Calibrate mode: records the range of ``x`` into ``module.<name>`` and
    returns ``x``. int8 mode, with that range recorded, shared points on
    and ``module`` not skipped: returns a ``QTensor``, the one s8 copy
    every consumer reads. Otherwise (and for a ``QTensor`` quantized by
    an outer scope) returns ``x`` as it is.
    """
    if isinstance(x, QTensor):
        return x
    mode = quant_mode()
    if mode == 'calibrate':
        record_amax(module, name, x)
        return x
    if (mode == 'int8' and name in module._buffers and quant_shared_points()
            and not quant_skipped(getattr(module, 'quant_path', ''))):
        return quantize_calibrated(module, x, name)
    return x


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
    Forward ``bn_stats`` (which also updates the running statistics in
    place, flax's ``0.9 * running + 0.1 * batch`` with the biased batch
    variance) and ``bn_apply``; backward ``bn_grad_stats`` and ``bn_dx``.

    With a ``mesh`` (``parallel/``: each rank holds a slice of the global
    batch) the statistics are the global batch's, and a BN is still two
    launches each way: forward, the local sums (``bn_local_sums``, the
    ``bn_stats`` launch) are all-reduced in place and ``bn_apply_sums``
    finalizes them with the global count ``m * world size`` (updating the
    running statistics, the same on every rank) and normalizes; backward,
    ``bn_grad_local_sums`` (the ``bn_grad_stats`` launch) writes the sums
    twice, one copy is all-reduced in place and ``bn_dx`` takes it with
    the global count. The weight and bias gradients stay the rank's own
    sums: the engine sums every parameter gradient over the ranks
    afterwards, and returning the all-reduced sums would count them once
    a rank.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                channel_dim, dtype, mesh=None):
        x = x.contiguous()
        ctx.mesh, ctx.m = mesh, None
        ctx.channel_dim = channel_dim
        if mesh is None:
            mean, _, rstd, scale = bn_stats(x, weight, eps, channel_dim,
                                            running_mean, running_var)
            ctx.save_for_backward(x, mean, rstd, scale)
            return bn_apply(x, mean, rstd, weight, bias, channel_dim, dtype)
        a, _, b = channel_view(x.shape, channel_dim)
        ctx.m = a * b * mesh.size
        y, (mean, _, rstd, scale) = bn_apply_sums(
            x, all_reduce(bn_local_sums(x, weight, eps, channel_dim), mesh),
            ctx.m, weight, bias, eps, channel_dim, dtype, running_mean,
            running_var)
        ctx.save_for_backward(x, mean, rstd, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        # autograd may hand over a strided gradient: the kernels read a
        # contiguous one
        dy = dy.contiguous()
        if ctx.mesh is None:
            sum_dy, sum_dy_xhat = bn_grad_stats(dy, x, mean, rstd,
                                                ctx.channel_dim)
            g_dy, g_dy_xhat = sum_dy, sum_dy_xhat
        else:
            sum_dy, sum_dy_xhat, sums = bn_grad_local_sums(
                dy, x, mean, rstd, ctx.channel_dim)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.mesh is not None:
                g_dy, g_dy_xhat = all_reduce(sums, ctx.mesh)
            dx = bn_dx(dy, x, mean, rstd, scale, g_dy, g_dy_xhat,
                       ctx.channel_dim, ctx.m)
        dbias = sum_dy if ctx.needs_input_grad[2] else None
        return dx, sum_dy_xhat, dbias, None, None, None, None, None, None


class _BatchNormEval(torch.autograd.Function):
    """Batch norm with given statistics: ``bn_apply`` forward. No model
    path differentiates an eval-mode BN; the backward keeps it
    differentiable, in plain ops: dx = dy * rstd * scale, dscale =
    sum(dy * xhat), dbias = sum(dy)."""

    @staticmethod
    def forward(ctx, x, mean, rstd, weight, bias, channel_dim, dtype):
        x = x.contiguous()
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.channel_dim = channel_dim
        return bn_apply(x, mean, rstd, weight, bias, channel_dim, dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, weight = ctx.saved_tensors
        a, c, b = channel_view(x.shape, ctx.channel_dim)
        g = dy.reshape(a, c, b).float()
        dx = dweight = dbias = None
        if ctx.needs_input_grad[0]:
            dx = (g * (rstd * weight).view(1, c, 1)).to(x.dtype) \
                .view(x.shape)
        if ctx.needs_input_grad[3]:
            xhat = (x.reshape(a, c, b).float() - mean.view(1, c, 1)) \
                * rstd.view(1, c, 1)
            dweight = (g * xhat).sum(dim=(0, 2))
        if ctx.needs_input_grad[4]:
            dbias = g.sum(dim=(0, 2))
        return dx, None, None, dweight, dbias, None, None


class FastBatchNorm(nn.Module):
    """Batch norm that normalizes in f32 and casts to ``dtype``.
    ``channel_dim`` is 1 for NCHW maps and -1 for feature-last
    embeddings (flax ``nn.BatchNorm`` on ``[N, D]`` and ``[N, K, D]``).

    Eval mode uses the running statistics (``_BatchNormEval``). Train
    mode uses the batch statistics (``_BatchNormTrain``) and updates the
    running ones as flax does: ``0.9 * running + 0.1 * batch``, with the
    biased batch variance. ``mesh`` (set by ``parallel.distribute_engine``)
    makes train mode take the statistics of every rank's slice.
    """
    mesh = None

    def __init__(self, num_features, eps=BN_EPS, bias=True, channel_dim=1,
                 dtype=torch.float32):
        super().__init__()
        self.eps, self.channel_dim, self.dtype = eps, channel_dim, dtype
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features)) if bias else None
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if self.training:
            return _BatchNormTrain.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, self.channel_dim, self.dtype,
                self.mesh)
        rstd = torch.rsqrt(self.running_var + self.eps)
        return _BatchNormEval.apply(x, self.running_mean, rstd, self.weight,
                                    self.bias, self.channel_dim, self.dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel norm of an NCHW map with an affine
    ``weight`` and ``bias`` (torch ``InstanceNorm2d(affine=True)``, no
    running statistics; flax ``GroupNorm(num_groups=C)`` in JAX). It
    normalizes in f32 and casts to ``dtype``, as flax does.

    ``F.instance_norm`` takes the variance as the mean of squared
    deviations; flax's ``GroupNorm`` takes E[x^2] - E[x]^2 (clipped at
    0). The two agree up to f32 rounding of that difference: a relative
    error of about 1e-7 * E[x^2] / var in the variance, so the outputs
    agree to about 1e-6 of their magnitude where a channel's mean is
    small beside its spread (the tests hold them to 1e-4).
    """

    def __init__(self, num_features, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))

    def forward(self, x):
        return F.instance_norm(x.float(), weight=self.weight, bias=self.bias,
                               eps=self.eps).to(self.dtype)


class GeneratorDropout(nn.Module):
    """Dropout (flax ``nn.Dropout``: kept entries divided by the keep
    probability) whose keep-mask is drawn from ``generator``, on its
    device; the identity in eval mode. In train mode without a
    generator it raises rather than draw from torch's global RNG. With a
    ``mesh`` (``parallel/``) it draws the global batch's mask and keeps
    this rank's slice: the masks of the one-process step."""
    mesh = None

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training:
            return x
        if self.generator is None:
            raise RuntimeError('GeneratorDropout in train mode needs a '
                               'generator (set_dropout_generator)')
        keep = 1.0 - self.rate
        shape, lo = tuple(x.shape), 0
        if self.mesh is not None:
            shape = (x.shape[0] * self.mesh.size,) + shape[1:]
            lo = x.shape[0] * self.mesh.rank
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device)[lo:lo + x.shape[0]] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_generator(model, generator):
    """Give every ``GeneratorDropout`` of ``model`` its generator."""
    for m in model.modules():
        if isinstance(m, GeneratorDropout):
            m.generator = generator


def _conv_bn(cin, cout, kernel, stride, dtype):
    return nn.Sequential(
        PConv(cin, cout, kernel, stride, kernel // 2, bias=False, dtype=dtype),
        FastBatchNorm(cout, dtype=dtype))


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual (expansion 1).

    ``quant_out``: under shared-point int8 inference the block returns a
    ``QTensor`` of its output (its own calibrated ``out_amax``), so its
    consumers read one s8 copy (JAX :282)."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 groups=1, base_width=64, quant_out=False,
                 dtype=torch.float32):
        del groups, base_width          # as in JAX: plain 3x3 convs
        super().__init__()
        self.quant_out, self.dtype = quant_out, dtype
        self.conv1 = PConv(inplanes, planes, 3, stride, 1, bias=False,
                           dtype=dtype)
        self.bn1 = FastBatchNorm(planes, dtype=dtype)
        self.conv2 = PConv(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = FastBatchNorm(planes, dtype=dtype)
        self.downsample = _conv_bn(inplanes, planes, 1, stride, dtype) \
            if has_downsample else None

    def forward(self, x):
        x = calibrated_quant(self, x)
        residual = dequantize(x, self.dtype) if isinstance(x, QTensor) \
            else x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        y = F.relu(out + residual)
        if self.quant_out:
            y = calibrated_quant(self, y, name='out_amax')
        return y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck + residual (expansion 4);
    ``groups``/``base_width`` give the ResNeXt variants; ``quant_out`` as
    for ``BasicBlock`` (JAX :343)."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 groups=1, base_width=64, quant_out=False,
                 dtype=torch.float32):
        super().__init__()
        self.quant_out, self.dtype = quant_out, dtype
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = PConv(inplanes, width, 1, 1, 0, bias=False, dtype=dtype)
        self.bn1 = FastBatchNorm(width, dtype=dtype)
        self.conv2 = PConv(width, width, 3, stride, 1, bias=False,
                           groups=groups, dtype=dtype)
        self.bn2 = FastBatchNorm(width, dtype=dtype)
        self.conv3 = PConv(width, planes * 4, 1, 1, 0, bias=False,
                           dtype=dtype)
        self.bn3 = FastBatchNorm(planes * 4, dtype=dtype)
        self.downsample = _conv_bn(inplanes, planes * 4, 1, stride, dtype) \
            if has_downsample else None

    def forward(self, x):
        x = calibrated_quant(self, x)
        residual = dequantize(x, self.dtype) if isinstance(x, QTensor) \
            else x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        y = F.relu(out + residual)
        if self.quant_out:
            y = calibrated_quant(self, y, name='out_amax')
        return y


class ResLayer(nn.Sequential):
    """A stack of residual blocks named ``0``, ``1``, ... like the
    reference's ``nn.Sequential``.

    ``quant_out``: the last block produces a ``QTensor`` under shared-point
    int8 inference (every consumer must take one); ``quant_blocks``: so do
    the others, whose only consumer is the next block (JAX :378). The
    producer's quantize equals the consumer's it replaces: the same
    tensor, the scale calibrated on it."""

    def __init__(self, block, inplanes, planes, num_blocks, stride=1,
                 groups=1, base_width=64, quant_out=False, quant_blocks=True,
                 dtype=torch.float32):
        needs_ds = stride != 1 or inplanes != planes * block.expansion
        kw = dict(groups=groups, base_width=base_width, dtype=dtype)
        last = num_blocks - 1
        blocks = [block(inplanes, planes, stride, needs_ds,
                        quant_out=quant_out if last == 0 else quant_blocks,
                        **kw)]
        blocks += [block(planes * block.expansion, planes, 1, False,
                         quant_out=quant_out if i == last else quant_blocks,
                         **kw)
                   for i in range(1, num_blocks)]
        super().__init__(*blocks)
        set_quant_paths(self)


def _lecun_normal_(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)


@torch.no_grad()
def init_parameters(module, generator):
    """Seeded init with the flax defaults: lecun-normal conv/dense
    kernels, zero biases, unit BN and instance-norm scales; BN running
    statistics reset to mean 0 / var 1. Visits modules in registration
    order, so the same generator state gives the same weights. Then a
    module with initializers of its own (a ``flax_init(generator)``
    method: HACNN's hard attention, MuDeep's fusion gates) sets them."""
    for m in module.modules():
        if isinstance(m, (PConv, Dense)):
            w = m.weight
            _lecun_normal_(w, w[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, InstanceNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FastBatchNorm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for m in module.modules():
        if hasattr(m, 'flax_init'):
            m.flax_init(generator)
