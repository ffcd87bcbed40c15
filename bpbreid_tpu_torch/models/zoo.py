"""Pieces the legacy Torchreid zoo shares (the port's counterparts of the
flax ops each JAX module of that zoo writes out for itself).

- ``conv``: a flax ``nn.Conv`` (float in every int8 mode, a
  ``quant=False`` ``PConv``) with torch's symmetric padding, square or
  ``(h, w)`` kernels;
- ``fc_layers`` and ``classify``: the global head, ``fc.<3i>`` Dense,
  ``fc.<3i+1>`` BN1d, ReLU, and the class scores in train mode;
- ``avg_pool_excl`` (the padding left out of the count, JAX's
  ``_avgpool_excl`` / ``_avg_excl``) and ``channel_shuffle``. JAX's
  hand-padded max pools are torch's own: ``F.max_pool2d(x, 3, 2,
  ceil_mode=True)`` for ``_max_pool_ceil``, ``F.max_pool2d(x, 3, 2)`` for
  ``_maxpool_nopad``.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import Dense, FastBatchNorm, PConv

__all__ = ['conv', 'ConvBNReLU', 'fc_layers', 'classify', 'avg_pool_excl',
           'channel_shuffle']


def conv(cin, cout, kernel, stride=1, padding=None, groups=1, bias=False,
         dtype=torch.float32):
    """A ``quant=False`` ``PConv``; ``padding`` defaults to ``kernel // 2``
    (each axis of an ``(h, w)`` kernel)."""
    if padding is None:
        padding = kernel // 2 if isinstance(kernel, int) \
            else tuple(k // 2 for k in kernel)
    return PConv(cin, cout, kernel, stride, padding, bias=bias,
                 groups=groups, dtype=dtype, quant=False)


class ConvBNReLU(nn.Module):
    """``conv`` + BN (``eps``) + ReLU, named ``conv`` and ``bn``."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None, bias=False,
                 eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, padding, bias=bias,
                         dtype=dtype)
        self.bn = FastBatchNorm(cout, eps=eps, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def fc_layers(in_dim, fc_dims, dtype):
    """The ``fc`` head of ``fc_dims`` (torch Sequential indices: Dense
    ``3i``, BN1d ``3i+1``, ReLU ``3i+2``); returns ``(head, out_dim)``,
    ``(None, in_dim)`` without ``fc_dims``."""
    if not fc_dims:
        return None, in_dim
    layers = []
    for dim in fc_dims:
        layers += [Dense(in_dim, dim, dtype=dtype),
                   FastBatchNorm(dim, channel_dim=-1, dtype=dtype),
                   nn.ReLU()]
        in_dim = dim
    return nn.Sequential(*layers), in_dim


def classify(model, v):
    """The embedding ``v`` in eval mode; in train mode the class scores
    of ``model.classifier`` (``'softmax'``) or ``(scores, v)``
    (``'triplet'``)."""
    if not model.training:
        return v
    y = model.classifier(v)
    if model.loss == 'softmax':
        return y
    if model.loss == 'triplet':
        return y, v
    raise KeyError('Unsupported loss: {}'.format(model.loss))


def avg_pool_excl(x, window=3, stride=1, padding=1):
    """Average pool whose count leaves the padding out
    (``count_include_pad=False``; JAX ``_avgpool_excl`` / ``_avg_excl``)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=False)


def channel_shuffle(x, groups=2):
    """Channel shuffle of an ``[N, C, H, W]`` map: channel ``j * groups +
    i`` takes channel ``i * C / groups + j`` (JAX ``channel_shuffle``)."""
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)
