"""Batch norm on the card: the per-channel sums of train mode, forward and
backward (port of the Pallas TPU kernels ``pallas_stats`` in
experiments/pallas_bn_v2.py:55 and experiments/pallas_bn_bench.py:82:
the statistic ``_bn_channel_sums`` of bpbreid_tpu/models/common.py:151),
and the elementwise passes that XLA fused around them on the TPU
(``_bn_train_fwd_core`` :191, ``_bn_train_vjp_bwd`` :211).

``x`` is viewed as ``[A, C, B]`` and reduced over A and B per channel,
``m = A*B``: NCHW maps (``channel_dim=1``) as ``[N, C, H*W]``,
feature-last ``[M, C]`` and ``[N, K, D]`` (``channel_dim=-1``) as
``[M, C, 1]`` and ``[N*K, D, 1]``.

- ``bn_stats(x, weight, eps)`` -> ``(mean, var, rstd, scale)``, f32
  ``[C]`` each: the batch statistics, ``scale = rstd * weight``; with
  ``running_mean``/``running_var`` it also updates those in place, as
  flax does (``MOMENTUM * running + (1 - MOMENTUM) * batch``);
- ``bn_apply(x, mean, rstd, weight, bias)`` -> ``y = (x - mean) *
  (rstd * weight) + bias`` in f32, cast to ``dtype``;
- ``bn_grad_stats(dy, x, mean, rstd)`` -> ``(sum dy, sum dy*xhat)``,
  ``xhat = (x - mean) * rstd``: dbias and dscale;
- ``bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat)`` -> ``dx =
  scale * (dy - sum_dy/m - xhat * sum_dy_xhat/m)`` in x's type.

Each is one kernel launch of ``bn_stats.cu`` for CUDA tensors, and
raises if it cannot launch it; the plain versions (``*_reference``) run
only for tensors on the CPU. The kernels take contiguous input and raise
otherwise: the caller makes a tensor contiguous explicitly.
"""
import torch

from bpbreid_tpu_torch.ops.cuda.build import (check_cuda_error, launch_counts,
                                              load_kernel)

__all__ = ['channel_view', 'reduce_splits', 'elementwise_splits',
           'bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx',
           'bn_stats_reference', 'bn_finalize_reference',
           'bn_apply_reference', 'bn_grad_stats_reference',
           'bn_dx_reference']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MOMENTUM = 0.9      # flax: running = 0.9 * running + 0.1 * batch
# CTAs a reduction cluster may hold (above 8: the non-portable size)
MAX_CLUSTER = 16
# a launch aims at about this many CTAs (8 per SM of an H100), each with
# at least _MIN_ELEMENTS elements (B > 1) or _MIN_ROWS rows (B == 1)
_TARGET_CTAS = 1024
_MIN_ELEMENTS = 8192
_COL_TILE, _MIN_ROWS = 32, 64


def channel_view(shape, channel_dim):
    """``(A, C, B)`` of a tensor of ``shape`` reduced per ``channel_dim``."""
    cd = channel_dim % len(shape)
    a = b = 1
    for s in shape[:cd]:
        a *= s
    for s in shape[cd + 1:]:
        b *= s
    return a, shape[cd], b


def _splits(a, c, b, most):
    if b == 1:
        tiles = -(-c // _COL_TILE)
        return max(1, min(most, -(-a // _MIN_ROWS),
                          -(-_TARGET_CTAS // tiles)))
    return max(1, min(most, -(-(a * b) // _MIN_ELEMENTS),
                      -(-_TARGET_CTAS // c)))


def reduce_splits(a, c, b):
    """CTAs in the cluster that owns a channel (``b > 1``) or a tile of 32
    channels (``b == 1``) in ``bn_stats`` and ``bn_grad_stats``."""
    return _splits(a, c, b, MAX_CLUSTER)


def elementwise_splits(a, c, b):
    """CTAs per channel (``b > 1``) or per tile of 32 channels (``b ==
    1``) in ``bn_apply`` and ``bn_dx``."""
    return _splits(a, c, b, 65535)


def bn_finalize_reference(s1, s2, m, weight, eps, running_mean=None,
                          running_var=None):
    """``bn_stats``'s epilogue on the sums ``s1 = sum x``, ``s2 = sum
    x*x`` of ``m`` values a channel (f32 ``[C]``)."""
    mean = s1 / m
    var = torch.clamp(s2 / m - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    if running_mean is not None:
        running_mean.copy_(MOMENTUM * running_mean + (1.0 - MOMENTUM) * mean)
        running_var.copy_(MOMENTUM * running_var + (1.0 - MOMENTUM) * var)
    return mean, var, rstd, rstd * weight


def bn_stats_reference(x, weight, eps, channel_dim=1, running_mean=None,
                       running_var=None, sums=False):
    """Plain PyTorch version of ``bn_stats``."""
    a, c, b = channel_view(x.shape, channel_dim)
    xf = x.reshape(a, c, b).float()
    s1, s2 = xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))
    out = bn_finalize_reference(s1, s2, a * b, weight, eps, running_mean,
                                running_var)
    return out + (s1, s2) if sums else out


def bn_apply_reference(x, mean, rstd, weight, bias=None, channel_dim=1,
                       dtype=None):
    """Plain PyTorch version of ``bn_apply``."""
    a, c, b = channel_view(x.shape, channel_dim)
    y = (x.reshape(a, c, b).float() - mean.view(1, c, 1)) \
        * (rstd * weight).view(1, c, 1)
    if bias is not None:
        y = y + bias.view(1, c, 1)
    return y.to(x.dtype if dtype is None else dtype).view(x.shape)


def bn_grad_stats_reference(dy, x, mean, rstd, channel_dim=1):
    """Plain PyTorch version of ``bn_grad_stats``."""
    a, c, b = channel_view(x.shape, channel_dim)
    dyf = dy.reshape(a, c, b).float()
    xhat = (x.reshape(a, c, b).float() - mean.view(1, c, 1)) \
        * rstd.view(1, c, 1)
    return dyf.sum(dim=(0, 2)), (dyf * xhat).sum(dim=(0, 2))


def bn_dx_reference(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat,
                    channel_dim=1):
    """Plain PyTorch version of ``bn_dx``."""
    a, c, b = channel_view(x.shape, channel_dim)
    m = a * b
    xhat = (x.reshape(a, c, b).float() - mean.view(1, c, 1)) \
        * rstd.view(1, c, 1)
    dx = scale.view(1, c, 1) * (
        dy.reshape(a, c, b).float() - (sum_dy / m).view(1, c, 1)
        - xhat * (sum_dy_xhat / m).view(1, c, 1))
    return dx.to(x.dtype).view(x.shape)


def _on_cuda(name, x):
    """False for a CPU tensor (the plain version runs); raises for any
    device but CUDA."""
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name, x.device))
    return True


def _check_inputs(name, *tensors):
    for t in tensors:
        if t.dtype not in _DTYPE_CODES:
            raise TypeError('{}: float32 or bfloat16 input expected, got {}'
                            .format(name, t.dtype))
        if not t.is_contiguous():
            raise ValueError('{}: contiguous input expected'.format(name))
        if t.device != tensors[0].device:
            raise ValueError('{}: inputs lie on different devices'
                             .format(name))
    if tensors[0].numel() == 0:
        raise ValueError('{}: empty input'.format(name))


def _check_vectors(name, c, device, **vectors):
    for key, v in vectors.items():
        if v is not None and (v.dtype != torch.float32
                              or tuple(v.shape) != (c,)
                              or not v.is_contiguous() or v.device != device):
            raise ValueError('{}: {} must be a contiguous f32 [{}] tensor on '
                             '{}'.format(name, key, c, device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, *args):
    lib, fn = load_kernel(name)
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_cuda_error(lib, code, name + ' kernel')
    launch_counts[name] += 1


def bn_stats(x, weight, eps, channel_dim=1, running_mean=None,
             running_var=None, sums=False):
    """Batch statistics of train-mode BN in one launch.

    Args:
        x: float32 or bfloat16, channels at ``channel_dim``.
        weight: f32 ``[C]``, the BN scale.
        running_mean, running_var: f32 ``[C]`` updated in place, or None.
        sums: also return ``(sum x, sum x*x)``.
    Returns:
        ``(mean, var, rstd, scale)``, f32 ``[C]`` each, then the two sums
        if ``sums``.
    """
    if not _on_cuda('bn_stats', x):
        with torch.no_grad():
            return bn_stats_reference(x, weight, eps, channel_dim,
                                      running_mean, running_var, sums)
    _check_inputs('bn_stats', x)
    a, c, b = channel_view(x.shape, channel_dim)
    _check_vectors('bn_stats', c, x.device, weight=weight,
                   running_mean=running_mean, running_var=running_var)
    if (running_mean is None) != (running_var is None):
        raise ValueError('bn_stats: running_mean and running_var go '
                         'together')
    out = torch.empty((6 if sums else 4, c), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _launch('bn_stats', x.data_ptr(), weight.data_ptr(),
                _ptr(running_mean), _ptr(running_var), out.data_ptr(),
                out[4].data_ptr() if sums else None, a, c, b,
                reduce_splits(a, c, b), eps, _DTYPE_CODES[x.dtype])
    return out.unbind(0)


def bn_apply(x, mean, rstd, weight, bias=None, channel_dim=1, dtype=None):
    """``y = (x - mean) * (rstd * weight) + bias`` in f32, cast to
    ``dtype`` (x's by default), in one launch.

    Args:
        x: float32 or bfloat16, channels at ``channel_dim``.
        mean, rstd, weight: f32 ``[C]``; bias: f32 ``[C]`` or None.
    """
    dtype = x.dtype if dtype is None else dtype
    if not _on_cuda('bn_apply', x):
        return bn_apply_reference(x, mean, rstd, weight, bias, channel_dim,
                                  dtype)
    _check_inputs('bn_apply', x)
    if dtype not in _DTYPE_CODES:
        raise TypeError('bn_apply: float32 or bfloat16 output expected, got '
                        '{}'.format(dtype))
    a, c, b = channel_view(x.shape, channel_dim)
    _check_vectors('bn_apply', c, x.device, mean=mean, rstd=rstd,
                   weight=weight, bias=bias)
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch('bn_apply', x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                weight.data_ptr(), _ptr(bias), y.data_ptr(), a, c, b,
                elementwise_splits(a, c, b), _DTYPE_CODES[x.dtype],
                _DTYPE_CODES[dtype])
    return y


def bn_grad_stats(dy, x, mean, rstd, channel_dim=1):
    """Per-channel ``(sum dy, sum dy * (x - mean) * rstd)`` in f32, in one
    launch.

    Args:
        dy, x: same shape, each float32 or bfloat16.
        mean, rstd: f32 ``[C]``.
    Returns:
        two f32 ``[C]`` tensors.
    """
    if dy.shape != x.shape:
        raise ValueError('dy {} and x {} differ in shape'.format(
            tuple(dy.shape), tuple(x.shape)))
    if not _on_cuda('bn_grad_stats', x):
        return bn_grad_stats_reference(dy, x, mean, rstd, channel_dim)
    _check_inputs('bn_grad_stats', x, dy)
    a, c, b = channel_view(x.shape, channel_dim)
    _check_vectors('bn_grad_stats', c, x.device, mean=mean, rstd=rstd)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch('bn_grad_stats', dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), out.data_ptr(), a, c, b,
                reduce_splits(a, c, b), _DTYPE_CODES[dy.dtype],
                _DTYPE_CODES[x.dtype])
    return out[0], out[1]


def bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat, channel_dim=1):
    """``dx = scale * (dy - sum_dy/m - xhat * sum_dy_xhat/m)`` with ``xhat
    = (x - mean) * rstd``, in x's type, in one launch.

    Args:
        dy, x: same shape, each float32 or bfloat16.
        mean, rstd, scale, sum_dy, sum_dy_xhat: f32 ``[C]``.
    """
    if dy.shape != x.shape:
        raise ValueError('dy {} and x {} differ in shape'.format(
            tuple(dy.shape), tuple(x.shape)))
    if not _on_cuda('bn_dx', x):
        return bn_dx_reference(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat,
                               channel_dim)
    _check_inputs('bn_dx', x, dy)
    a, c, b = channel_view(x.shape, channel_dim)
    _check_vectors('bn_dx', c, x.device, mean=mean, rstd=rstd, scale=scale,
                   sum_dy=sum_dy, sum_dy_xhat=sum_dy_xhat)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch('bn_dx', dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), scale.data_ptr(), sum_dy.data_ptr(),
                sum_dy_xhat.data_ptr(), dx.data_ptr(), a, c, b,
                elementwise_splits(a, c, b), _DTYPE_CODES[dy.dtype],
                _DTYPE_CODES[x.dtype])
    return dx
