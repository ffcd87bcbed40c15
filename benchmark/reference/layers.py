"""The layers every plain reference builds from: convolutions, linear
layers and batch norms in float32 through ``F.conv2d``, ``F.linear`` and
``F.batch_norm`` (the caller turns TF32 off, ``precision``).

The counts (``benchmark/counts.py``) hook ``BN`` by its class, and the
lower-precision control goes through ``_product``: under
``PRECISION['mode'] = 'fp8'`` both operands of every convolution and
linear layer, depthwise and grouped ones included, are rounded to float8
e4m3 at a per-tensor scale, as FP8 training does, and the gradients that
flow back to the activations go through e5m2 (``'int8'``: int8 both
ways). A reference built from other layers would miss both.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ['BN', 'BN_EPS', 'Conv', 'Linear', 'PRECISION', 'conv2d',
           'linear', 'precision']

# 'f32', 'fp8' or 'int8' (see the module docstring)
PRECISION = {'mode': 'f32'}
BN_EPS = 1e-5

# mode -> (format of the forward products' operands, format of the
# output gradient that the backward products take)
FORMATS = {'fp8': ('e4m3', 'e5m2'), 'int8': ('int8', 'int8')}
_TOP = {'e4m3': 448.0, 'e5m2': 57344.0, 'int8': 127.0}


def _quantize(x, fmt):
    """``x`` through ``fmt`` (``e4m3``, ``e5m2`` or ``int8``) at a
    per-tensor scale, and back."""
    top = _TOP[fmt]
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    if fmt == 'int8':
        return torch.round(x / scale).clamp(-top, top) * scale
    dtype = torch.float8_e4m3fn if fmt == 'e4m3' else torch.float8_e5m2
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """An operand through the forward format; its gradient passes
    unchanged."""

    @staticmethod
    def forward(ctx, x, fmt):
        return _quantize(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _OutputGrad(torch.autograd.Function):
    """The identity forward; backward, the output gradient through the
    backward format before the data- and weight-gradient products take it
    (for fp8 the recipe of Micikevicius et al., 2022: e4m3 forward, e5m2
    backward)."""

    @staticmethod
    def forward(ctx, y, fmt):
        ctx.fmt = fmt
        return y

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, ctx.fmt), None


def _product(fn, x, w, b, *args):
    fmt = FORMATS.get(PRECISION['mode'])
    if fmt is None:
        return fn(x, w, b, *args)
    y = fn(_Operand.apply(x, fmt[0]), _Operand.apply(w, fmt[0]), b, *args)
    return _OutputGrad.apply(y, fmt[1])


def conv2d(x, w, b=None, stride=1, padding=0, groups=1):
    return _product(F.conv2d, x, w, b, stride, padding, 1, groups)


def linear(x, w, b=None):
    return _product(F.linear, x, w, b)


class Conv(nn.Module):
    """A square convolution; ``groups = cin = cout`` is a depthwise one."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=False,
                 groups=1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.groups)


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class BN(nn.Module):
    """Batch norm over dim 1 of a map, or over the last dim of ``[N, D]``
    and ``[N, K, D]`` embeddings (statistics over every other dim)."""

    def __init__(self, c, bias=True):
        super().__init__()
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c)) if bias else None
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x):
        shape = x.shape
        if x.dim() == 3:
            x = x.reshape(-1, shape[-1])
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, self.training, self.momentum, BN_EPS)
        return y.reshape(shape)


class precision:
    """Context: the reference's arithmetic, float32 with TF32 off
    (``'f32'``) or float8 operands (``'fp8'``); restores the settings."""

    def __init__(self, mode='f32'):
        self.mode = mode

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32, PRECISION['mode'])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        PRECISION['mode'] = self.mode
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, PRECISION['mode']) = self.saved
        return False
