"""Per-channel batch-norm sums, forward and backward (port of the Pallas
TPU kernels ``pallas_stats`` in experiments/pallas_bn_v2.py:55 and
experiments/pallas_bn_bench.py:82: the train-mode statistic
``_bn_channel_sums`` of bpbreid_tpu/models/common.py:151).

``x`` is viewed as ``[A, C, B]`` and reduced over A and B per channel:
NCHW maps (``channel_dim=1``) as ``[N, C, H*W]``, feature-last ``[M, C]``
and ``[N, K, D]`` (``channel_dim=-1``) as ``[M, C, 1]`` and ``[N*K, D, 1]``.

- ``bn_stats(x)`` -> ``(sum x, sum x*x)``, the forward statistics;
- ``bn_grad_stats(dy, x, mean, rstd)`` -> ``(sum dy, sum dy*xhat)`` with
  ``xhat = (x - mean) * rstd``, the backward reductions.

Both return f32 ``[C]`` for float32 or bfloat16 input. For CUDA tensors
they launch the kernel of ``bn_stats.cu`` and raise if they cannot;
the plain versions (``*_reference``) run only for tensors on the CPU.
The kernels take contiguous input and raise otherwise: the caller makes
a tensor contiguous explicitly.
"""
import torch

from bpbreid_tpu_torch.ops.cuda.build import (check_cuda_error, launch_counts,
                                              load_kernel)

__all__ = ['channel_view', 'bn_stats', 'bn_grad_stats', 'bn_stats_reference',
           'bn_grad_stats_reference', 'num_splits']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the partial pass aims at about this many blocks (8 per SM of an H100),
# each with at least _MIN_PER_BLOCK elements
_TARGET_BLOCKS = 1024
_MIN_PER_BLOCK = 8192
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


def num_splits(a, c, b):
    """Blocks per channel (or per 32-channel tile when ``b == 1``) of the
    partial pass."""
    if b == 1:
        tiles = -(-c // _COL_TILE)
        return max(1, min(-(-a // _MIN_ROWS), -(-_TARGET_BLOCKS // tiles)))
    return max(1, min(-(-_TARGET_BLOCKS // c), -(-(a * b) // _MIN_PER_BLOCK),
                      65535))


def bn_stats_reference(x, channel_dim=1):
    """Plain PyTorch version of ``bn_stats``."""
    xf = x.reshape(channel_view(x.shape, channel_dim)).float()
    return xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))


def bn_grad_stats_reference(dy, x, mean, rstd, channel_dim=1):
    """Plain PyTorch version of ``bn_grad_stats``."""
    a, c, b = channel_view(x.shape, channel_dim)
    dyf = dy.reshape(a, c, b).float()
    xhat = (x.reshape(a, c, b).float() - mean.view(1, c, 1)) \
        * rstd.view(1, c, 1)
    return dyf.sum(dim=(0, 2)), (dyf * xhat).sum(dim=(0, 2))


def _check_cuda(name, *tensors):
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


def bn_stats(x, channel_dim=1):
    """Per-channel ``(sum x, sum x*x)`` in f32.

    Args:
        x: float32 or bfloat16, channels at ``channel_dim``.
    Returns:
        two f32 ``[C]`` tensors.
    """
    if x.device.type == 'cpu':
        return bn_stats_reference(x, channel_dim)
    if x.device.type != 'cuda':
        raise ValueError('unsupported device {}'.format(x.device))
    _check_cuda('bn_stats', x)
    a, c, b = channel_view(x.shape, channel_dim)
    s = num_splits(a, c, b)
    lib, fn = load_kernel('bn_stats')
    part = torch.empty((2, s, c), dtype=torch.float64, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), part.data_ptr(), out.data_ptr(), a, c, b, s,
                  _DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream().cuda_stream)
    check_cuda_error(lib, code, 'bn_stats kernel')
    launch_counts['bn_stats'] += 1
    return out[0], out[1]


def bn_grad_stats(dy, x, mean, rstd, channel_dim=1):
    """Per-channel ``(sum dy, sum dy * (x - mean) * rstd)`` in f32.

    Args:
        dy, x: same shape, each float32 or bfloat16.
        mean, rstd: f32 ``[C]``.
    Returns:
        two f32 ``[C]`` tensors.
    """
    if dy.shape != x.shape:
        raise ValueError('dy {} and x {} differ in shape'.format(
            tuple(dy.shape), tuple(x.shape)))
    if x.device.type == 'cpu':
        return bn_grad_stats_reference(dy, x, mean, rstd, channel_dim)
    if x.device.type != 'cuda':
        raise ValueError('unsupported device {}'.format(x.device))
    _check_cuda('bn_grad_stats', x, dy)
    a, c, b = channel_view(x.shape, channel_dim)
    for name, v in (('mean', mean), ('rstd', rstd)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) \
                or not v.is_contiguous() or v.device != x.device:
            raise ValueError('bn_grad_stats: {} must be a contiguous f32 [{}] '
                             'tensor on {}'.format(name, c, x.device))
    s = num_splits(a, c, b)
    lib, fn = load_kernel('bn_grad_stats')
    part = torch.empty((2, s, c), dtype=torch.float64, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                  rstd.data_ptr(), part.data_ptr(), out.data_ptr(), a, c, b, s,
                  _DTYPE_CODES[dy.dtype], _DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream().cuda_stream)
    check_cuda_error(lib, code, 'bn_grad_stats kernel')
    launch_counts['bn_grad_stats'] += 1
    return out[0], out[1]
