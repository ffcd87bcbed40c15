"""int8 convolution and the static activation quantize on the card
(``conv_s8.cu``). No TPU kernel of the repository does this work: on the
TPU, XLA compiled ``quant_conv`` (bpbreid_tpu/ops/quant.py:327) and
``quantize_static`` (:288); PyTorch has no int8 convolution on CUDA.

- ``quantize_s8(x, scale)``: ``x`` ``[N, C, H, W]`` f32 or bf16 (NCHW or
  channels-last in memory) -> the NHWC s8 copy ``[N, H, W, Cp]``, ``Cp``
  = C rounded up to a multiple of 32, ``clip(round(x / scale), -127,
  127)`` with a per-tensor (``()`` or ``[1]``) or per-channel ``[C]``
  scale, f32 and already floored by the caller; the pad channels are 0;
- ``conv_s8(xq, w, sw, bias, kernel_size, stride, padding, channels,
  groups, out_dtype)``: ``xq`` as ``quantize_s8`` gives it, ``w`` the s8
  weights packed by ``pack_weight_s8`` (``[Co, k*k*Cp]``, K-major), ``sw``
  the f32 ``[Co]`` dequant scale, ``bias`` f32 ``[Co]`` or None -> ``y =
  out_dtype(float(acc) * sw)``, then ``y + out_dtype(bias)`` in
  ``out_dtype``, NCHW ``[N, Co, Ho, Wo]``; ``acc`` is the exact int32 sum
  of the s8 products.

Each is one kernel launch for CUDA tensors, and raises if it cannot
launch it; the plain versions (``*_reference``) run only for tensors on
the CPU. ``conv_s8`` with ``groups > 1`` (ResNeXt's grouped 3x3) has a
plain version but no kernel yet: on the card it raises.
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.cuda.build import (check_cuda_error, launch_counts,
                                              load_kernel)

__all__ = ['CHANNEL_ALIGN', 'padded_channels', 'pack_weight_s8',
           'plan_conv_tiles', 'quantize_s8', 'quantize_s8_reference',
           'conv_s8', 'conv_s8_accumulate', 'conv_s8_reference']

CHANNEL_ALIGN = 32          # the s8 copy's channels: one mma k-step
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132                  # streaming multiprocessors of an H100 SXM


def padded_channels(c):
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def pack_weight_s8(wq, cp, groups=1):
    """s8 OIHW weights -> ``[Co, k*k*Kc]`` (K-major, taps in (r, s) order,
    then the input channels): ``Kc = cp`` with zero pad channels for
    ``groups == 1``, the group's ``Cin / groups`` channels otherwise."""
    co, cin_g = wq.shape[:2]
    w = wq.permute(0, 2, 3, 1)
    if groups == 1 and cp > cin_g:
        w = F.pad(w, (0, cp - cin_g))
    return w.reshape(co, -1).contiguous()


def plan_conv_tiles(m, co, cp):
    """``(BM, BN, KC)`` of a ``conv_s8`` launch: M pixels, Co output
    channels, Cp input channels. 64-row tiles where 128-row ones would
    leave SMs idle."""
    bn = 32 if co <= 32 else 64
    bm = 128 if -(-m // 128) * -(-co // bn) >= _SMS else 64
    kc = 64 if cp % 64 == 0 else 32
    return bm, bn, kc


def quantize_s8_reference(x, scale):
    """Plain PyTorch version of ``quantize_s8``."""
    c = x.shape[1]
    s = scale.reshape(1, c, 1, 1) if scale.numel() > 1 else scale.reshape(())
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    q = q.permute(0, 2, 3, 1)
    cp = padded_channels(c)
    if cp > c:
        q = F.pad(q, (0, cp - c))
    return q.contiguous()


def conv_s8_accumulate(xq, w, kernel_size, stride=1, padding=0,
                       channels=None, groups=1):
    """The int32 sums of ``conv_s8``: a float64 convolution of the s8
    values, exact (every partial sum is an integer below 2**53). cuDNN is
    off for it: its FFT and Winograd algorithms would round."""
    cin = xq.shape[-1] if channels is None else channels
    co, k = w.shape[0], kernel_size
    kc = w.shape[1] // (k * k)
    x = xq[..., :cin].permute(0, 3, 1, 2).double()
    w4 = w.view(co, k, k, kc)[..., :cin // groups].permute(0, 3, 1, 2) \
        .double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, w4, None, stride, padding, 1, groups)
    return acc.to(torch.int32)


def conv_s8_reference(xq, w, sw, bias=None, kernel_size=1, stride=1,
                      padding=0, channels=None, groups=1,
                      out_dtype=torch.bfloat16):
    """Plain PyTorch version of ``conv_s8``."""
    acc = conv_s8_accumulate(xq, w, kernel_size, stride, padding, channels,
                             groups)
    y = (acc.float() * sw.view(1, -1, 1, 1)).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype).view(1, -1, 1, 1)
    return y.contiguous()


def _on_cuda(name, x):
    """False for a CPU tensor (the plain version runs); raises for any
    device but CUDA."""
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError('{}: unsupported device {}'.format(name, x.device))
    return True


def _check_vector(name, key, v, n, device):
    if v is not None and (v.dtype != torch.float32 or v.numel() != n
                          or not v.is_contiguous() or v.device != device):
        raise ValueError('{}: {} must be a contiguous f32 tensor of {} '
                         'values on {}'.format(name, key, n, device))


def _launch(name, *args):
    lib, fn = load_kernel(name)
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_cuda_error(lib, code, name + ' kernel')
    launch_counts[name] += 1


def quantize_s8(x, scale):
    """Static int8 quantize in one launch.

    Args:
        x: ``[N, C, H, W]`` float32 or bfloat16.
        scale: f32, one value or ``[C]``, floored by the caller.
    Returns:
        s8 ``[N, H, W, Cp]``, ``Cp = padded_channels(C)``.
    """
    if x.dim() != 4:
        raise ValueError('quantize_s8: [N, C, H, W] input expected, got {}'
                         .format(tuple(x.shape)))
    if not _on_cuda('quantize_s8', x):
        return quantize_s8_reference(x, scale)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError('quantize_s8: float32 or bfloat16 input expected, '
                        'got {}'.format(x.dtype))
    n, c, h, w = x.shape
    if scale.numel() not in (1, c):
        raise ValueError('quantize_s8: {} scale values for {} channels'
                         .format(scale.numel(), c))
    _check_vector('quantize_s8', 'scale', scale, scale.numel(), x.device)
    if x.numel() == 0 or n > 65535:
        raise ValueError('quantize_s8: input {} out of the kernel\'s range'
                         .format(tuple(x.shape)))
    # the kernel reads NCHW or channels-last memory; any other strides
    # are copied to NCHW first
    channels_last = int(not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last))
    if not channels_last:
        x = x.contiguous()
    cp = padded_channels(c)
    q = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _launch('quantize_s8', x.data_ptr(), scale.data_ptr(),
                int(scale.numel() > 1), q.data_ptr(), n, c, h * w, cp,
                _DTYPE_CODES[x.dtype], channels_last)
    return q


def conv_s8(xq, w, sw, bias=None, kernel_size=1, stride=1, padding=0,
            channels=None, groups=1, out_dtype=torch.bfloat16):
    """int8 x int8 -> int32 convolution with the dequantizing epilogue,
    in one launch.

    Args:
        xq: s8 ``[N, H, W, Cp]`` (``quantize_s8``), the pad channels 0.
        w: s8 ``[Co, k*k*Kc]`` (``pack_weight_s8``).
        sw: f32 ``[Co]``; bias: f32 ``[Co]`` or None.
        kernel_size, stride, padding: square kernel, symmetric padding.
        channels: the logical input channels (``Cp`` by default).
        groups: 1 on the card.
        out_dtype: float32 or bfloat16.
    Returns:
        ``[N, Co, Ho, Wo]`` in ``out_dtype``.
    """
    if xq.dim() != 4 or w.dim() != 2:
        raise ValueError('conv_s8: xq [N, H, W, Cp] and w [Co, K] expected, '
                         'got {} and {}'.format(tuple(xq.shape),
                                                tuple(w.shape)))
    if not _on_cuda('conv_s8', xq):
        return conv_s8_reference(xq, w, sw, bias, kernel_size, stride,
                                 padding, channels, groups, out_dtype)
    if groups != 1:
        raise NotImplementedError(
            'conv_s8: grouped int8 convolutions (groups={}) have no kernel '
            'yet; run this model with test.int8 False on the card (ROADMAP '
            'Queue 1)'.format(groups))
    n, h, wd, cp = xq.shape
    co, k = w.shape[0], kernel_size
    for t, dt in ((xq, torch.int8), (w, torch.int8)):
        if t.dtype != dt or not t.is_contiguous() or t.device != xq.device:
            raise ValueError('conv_s8: contiguous s8 xq and w on one device '
                             'expected')
    if cp % CHANNEL_ALIGN or xq.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError('conv_s8: Cp {} must be a multiple of {}, and xq '
                         'and w 16-byte aligned'.format(cp, CHANNEL_ALIGN))
    if w.shape[1] != k * k * cp:
        raise ValueError('conv_s8: w {} does not match {}x{} taps of {} '
                         'channels'.format(tuple(w.shape), k, k, cp))
    if out_dtype not in _DTYPE_CODES:
        raise TypeError('conv_s8: float32 or bfloat16 output expected, got '
                        '{}'.format(out_dtype))
    _check_vector('conv_s8', 'sw', sw, co, xq.device)
    _check_vector('conv_s8', 'bias', bias, co, xq.device)
    ho = (h + 2 * padding - k) // stride + 1
    wo = (wd + 2 * padding - k) // stride + 1
    if min(n, h, wd, ho, wo) <= 0:
        raise ValueError('conv_s8: empty output for input {} and kernel {}, '
                         'stride {}, padding {}'.format(
                             tuple(xq.shape), k, stride, padding))
    y = torch.empty((n, co, ho, wo), dtype=out_dtype, device=xq.device)
    bm, bn, kc = plan_conv_tiles(n * ho * wo, co, cp)
    with torch.cuda.device(xq.device):
        _launch('conv_s8', xq.data_ptr(), w.data_ptr(), sw.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(), n,
                h, wd, cp, co, ho, wo, k, k, stride, padding,
                int(out_dtype == torch.bfloat16), bm, bn, kc)
    return y
