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
the CPU. ``conv_s8`` with ``groups > 1`` (ResNeXt's grouped 3x3) runs
on the card as one dense conv over block-diagonal weights
(``expand_grouped_weight_s8``, exact in int32).

``plan_conv_tiles`` is the kernel's tile plan, in plain Python so that
the CPU tests reach it: a tile is ``th x tw`` output pixels of one image
by ``bn`` output channels; persistent CTAs walk the tiles, each tile in
chunks of ``kc`` input channels through a ring of ``stages``
shared-memory stages, a chunk one TMA load of A's halo (``tma_box``),
with B in shared memory once per CTA (``b_resident``) or a chunk a stage.
``conv_layout`` lays out that shared memory; the kernel's C entry point
takes the layout as given and only checks it.
"""
import collections
import functools

import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.ops.cuda.build import (check_cuda_error, launch_counts,
                                              load_kernel)

__all__ = ['CHANNEL_ALIGN', 'padded_channels', 'pack_weight_s8',
           'expand_grouped_weight_s8', 'ConvPlan', 'ConvLayout',
           'plan_conv_tiles', 'halo_box', 'conv_tiles', 'rows_groupable',
           'tma_box', 'b_resident', 'conv_layout', 'check_conv_plan',
           'quantize_s8', 'quantize_s8_reference', 'conv_s8',
           'conv_s8_accumulate', 'conv_s8_reference', 'SERVING_STEP_CONVS',
           'SERVING_STEP_QUANTS']

CHANNEL_ALIGN = 32          # the s8 copy's channels: one mma k-step
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448         # shared memory a CTA can use (227 KB)
TMA_BOX_LIMIT = 256         # elements of a TMA box dimension
_TILE_WIDTHS = (32, 16, 8, 4)
_SMEM_TARGET = 116 * 1024   # a CTA's shared memory: two CTAs an SM
_B_RESIDENT_LIMIT = 80 * 1024

_QUANT_MAX_CHANNELS = 8192  # per-channel scales staged in shared memory

# The int8 serving step's calls, for which the plan was tuned: HRNet-W32
# BPBReID at 384x128, batch 64, bf16, JAX's default int8 graph (the float
# stem's 2 convs excluded). conv_s8: launches a step by (N, Cin, H, W, Co,
# k, stride, padding), every one ungrouped, bf16 out, no bias (319 in 33
# shapes); quantize_s8: by (N, C, H, W, memory layout), bf16, one scale
# (275 in 10). chip_smoke.py phase 12 checks them against the model's step.
SERVING_STEP_CONVS = {
    (64, 32, 24, 8, 256, 3, 2, 1): 3, (64, 32, 48, 16, 32, 3, 2, 1): 3,
    (64, 32, 48, 16, 128, 3, 2, 1): 7, (64, 32, 96, 32, 32, 1, 1, 0): 1,
    (64, 32, 96, 32, 32, 3, 1, 1): 65, (64, 32, 96, 32, 32, 3, 2, 1): 10,
    (64, 32, 96, 32, 64, 3, 2, 1): 8, (64, 32, 96, 32, 128, 1, 1, 0): 2,
    (64, 64, 24, 8, 256, 3, 2, 1): 3, (64, 64, 48, 16, 32, 1, 1, 0): 8,
    (64, 64, 48, 16, 64, 1, 1, 0): 1, (64, 64, 48, 16, 64, 3, 1, 1): 65,
    (64, 64, 48, 16, 64, 3, 2, 1): 3, (64, 64, 48, 16, 128, 3, 2, 1): 8,
    (64, 64, 48, 16, 256, 1, 1, 0): 2, (64, 64, 96, 32, 64, 1, 1, 0): 1,
    (64, 64, 96, 32, 64, 3, 1, 1): 4, (64, 64, 96, 32, 256, 1, 1, 0): 5,
    (64, 128, 24, 8, 32, 1, 1, 0): 7, (64, 128, 24, 8, 64, 1, 1, 0): 7,
    (64, 128, 24, 8, 128, 1, 1, 0): 1, (64, 128, 24, 8, 128, 3, 1, 1): 57,
    (64, 128, 24, 8, 256, 3, 2, 1): 4, (64, 128, 24, 8, 512, 1, 1, 0): 2,
    (64, 256, 12, 4, 32, 1, 1, 0): 3, (64, 256, 12, 4, 64, 1, 1, 0): 3,
    (64, 256, 12, 4, 128, 1, 1, 0): 3, (64, 256, 12, 4, 256, 1, 1, 0): 1,
    (64, 256, 12, 4, 256, 3, 1, 1): 25, (64, 256, 12, 4, 1024, 1, 1, 0): 2,
    (64, 256, 96, 32, 32, 3, 1, 1): 1, (64, 256, 96, 32, 64, 1, 1, 0): 3,
    (64, 256, 96, 32, 64, 3, 2, 1): 1}
SERVING_STEP_QUANTS = {
    (64, 32, 24, 8, 'nchw'): 3, (64, 32, 48, 16, 'nchw'): 10,
    (64, 32, 96, 32, 'nchw'): 67, (64, 32, 96, 32, 'nhwc'): 8,
    (64, 64, 24, 8, 'nchw'): 3, (64, 64, 48, 16, 'nchw'): 75,
    (64, 64, 96, 32, 'nchw'): 9, (64, 128, 24, 8, 'nchw'): 66,
    (64, 256, 12, 4, 'nchw'): 30, (64, 256, 96, 32, 'nchw'): 4}
ConvPlan = collections.namedtuple('ConvPlan', 'th tw bn kc stages grouped')
ConvLayout = collections.namedtuple(
    'ConvLayout', 'box_inner box_cols box_rows b_resident b_ld halo_bytes '
    'stage_bytes b_offset tile_offset bar_offset smem')


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


def expand_grouped_weight_s8(w, kernel_size, cp, channels, groups):
    """Grouped packed weights ``[Co, k*k*Cin/groups]`` -> the dense
    block-diagonal ``[Co, k*k*Cp]`` of the same conv: output channel ``o``
    of group ``g`` keeps its weights on input channels ``g*Cin/groups ..
    (g+1)*Cin/groups - 1`` and 0 elsewhere, so the int32 sums are the
    grouped conv's."""
    co, kk = w.shape[0], kernel_size * kernel_size
    cin_g, cout_g = channels // groups, co // groups
    src = w.view(co, kk, cin_g)
    dense = torch.zeros(co, kk, cp, dtype=w.dtype, device=w.device)
    for g in range(groups):
        dense[g * cout_g:(g + 1) * cout_g, :, g * cin_g:(g + 1) * cin_g] = \
            src[g * cout_g:(g + 1) * cout_g]
    return dense.view(co, kk * cp)


def _ceil(a, b):
    return -(-a // b)


def halo_box(plan, kernel_size, stride):
    """``(rows, cols)`` of the input pixels a tile of ``plan`` reads."""
    return ((plan.th - 1) * stride + kernel_size,
            (plan.tw - 1) * stride + kernel_size)


def conv_tiles(plan, ho, wo):
    """``(tiles_h, tiles_w)``: the tile grid over one image's output."""
    return _ceil(ho, plan.th), _ceil(wo, plan.tw)


def _round(v, a):
    return _ceil(v, a) * a


def rows_groupable(kc, cp, width):
    """Whether A's TMA box rows can be 128-byte units of an image row
    (``128 / cp`` pixels each): one chunk of ``cp <= 64`` channels, the
    row ``width * cp`` a multiple of 128."""
    return kc == cp <= 64 and width * cp % 128 == 0


def tma_box(plan, kernel_size, stride, padding, cp):
    """A's TMA box, innermost first, in bytes along dim 0: ``(128,
    units, rows, 1)`` over ``[N, H, W * cp / 128, 128]`` for grouped rows,
    from the unit that holds the halo's first pixel; else ``(kc, cols,
    rows, 1)`` over ``[N, H, W, Cp]``. TMA's swizzle is ``box[0]``
    bytes."""
    rows, cols = halo_box(plan, kernel_size, stride)
    if plan.grouped:
        per_unit = 128 // cp
        return (128, _ceil(-padding % per_unit + cols, per_unit), rows, 1)
    return (plan.kc, cols, rows, 1)


def b_resident(plan, kernel_size, cp):
    """Whether a CTA loads all of B once (one chunk, or at most 80 KB of
    padded rows) rather than one chunk a ring stage."""
    return cp == plan.kc or plan.bn * (kernel_size ** 2 * cp + 16) \
        <= _B_RESIDENT_LIMIT


def conv_layout(plan, kernel_size, stride, padding, cp, out_bf16=True):
    """The ``ConvLayout`` of a launch's dynamic shared memory, its one
    owner (the C entry point takes it and only checks it): A's TMA box
    (``tma_box``), B resident or not, B's row of ``b_ld`` bytes (padded
    by 16, so that ldmatrix's 8 rows fall in 8 bank groups), the halo and
    a ring stage (the halo, and a B chunk unless B is resident), then
    ``stages`` stages, resident B, the epilogue tile (``[bn][th*tw + 8]``
    bf16 or ``[bn][th*tw + 4]`` f32), the mbarriers, and 1024 bytes to
    align the base; the halo and B start on 1024 bytes (TMA's swizzle
    repeats at 1024)."""
    box = tma_box(plan, kernel_size, stride, padding, cp)
    kk = kernel_size ** 2
    resident = b_resident(plan, kernel_size, cp)
    b_ld = (cp if resident else plan.kc) * kk + 16
    b = _round(plan.bn * b_ld, 1024)
    halo = _round(box[0] * box[1] * box[2], 1024)
    stage = halo + (0 if resident else b)
    b_offset = plan.stages * stage
    tile_offset = b_offset + (b if resident else 0)
    bm = plan.th * plan.tw
    tile = plan.bn * (bm + 8) * 2 if out_bf16 else plan.bn * (bm + 4) * 4
    bar_offset = _round(tile_offset + tile, 8)
    return ConvLayout(box[0], box[1], box[2], int(resident), b_ld, halo,
                      stage, b_offset, tile_offset, bar_offset,
                      bar_offset + 8 * plan.stages + 1024)


def _best_tile(bm, ho, wo):
    """The ``(th, tw)`` with ``th * tw = bm`` that covers one image's
    ``ho x wo`` output with the fewest pixels, the widest on a tie."""
    return min(((bm // tw, tw) for tw in _TILE_WIDTHS),
               key=lambda t: (_ceil(ho, t[0]) * _ceil(wo, t[1]), -t[1]))


@functools.lru_cache(maxsize=None)
def plan_conv_tiles(n, h, w, cp, co, kernel_size, stride, padding,
                    out_bf16=True):
    """The ``ConvPlan`` of a ``conv_s8`` launch on ``[n, h, w, cp]`` s8
    input with ``co`` output channels, bf16 or f32 out. The kernel runs
    one wave of persistent CTAs, so the plan sizes the tile, not the
    grid.

    - ``bn``: 32 where ``co <= 32`` and for a k x k conv (k > 1) with
      ``co <= 128`` (more, smaller CTAs measured faster there), else 64;
    - ``th x tw``: 128 pixels where that covers no more output pixels
      than 64-pixel tiles, else 64; among tiles of that size the one that
      wastes fewest pixels, the widest on a tie (wide rows store long
      runs of one channel);
    - ``kc`` and ``grouped``: all ``cp <= 64`` channels in one chunk
      where an image row is whole 128-byte units (``rows_groupable``),
      else 128, 64 or 32, the largest that divides ``cp``; A's TMA box
      rows grouped into 128-byte units wherever they can be, but at
      ``cp`` 64 in a stride-1 k x k conv, where one pixel's 64 bytes a
      row measured faster (``int8_bench.py --box-rows``);
    - ``stages``: 3, or 2 where three would pass 116 KB (two CTAs an
      SM); where two still would, the next smaller ``kc``.
    """
    ho = (h + 2 * padding - kernel_size) // stride + 1
    wo = (w + 2 * padding - kernel_size) // stride + 1
    bn = 32 if co <= 32 or (kernel_size > 1 and co <= 128) else 64
    tiles = {}
    for bm in (128, 64):
        th, tw = _best_tile(bm, ho, wo)
        tiles[bm] = (th, tw, _ceil(ho, th) * _ceil(wo, tw) * bm)
    th, tw = (tiles[128] if tiles[128][2] <= tiles[64][2]
              else tiles[64])[:2]
    chunks = [k for k in (128, 64, 32) if cp % k == 0]
    if rows_groupable(cp, cp, w):
        chunks = [cp] + [k for k in chunks if k < cp]
    grouped = {kc: rows_groupable(kc, cp, w) and not (
        cp == 64 and kernel_size > 1 and stride == 1) for kc in chunks}
    plans = [ConvPlan(th, tw, bn, kc, stages, grouped[kc])
             for kc in chunks for stages in (3, 2)]
    sizes = [conv_layout(p, kernel_size, stride, padding, cp, out_bf16).smem
             for p in plans]
    return next((p for p, b in zip(plans, sizes) if b <= _SMEM_TARGET),
                plans[sizes.index(min(sizes))])


def check_conv_plan(plan, kernel_size, stride, padding, cp, width,
                    out_bf16=True):
    """``plan``'s ``ConvLayout``; raises where TMA or the card cannot run
    it: grouped rows where an image row is not whole 128-byte units, a
    box dimension over 256, more than 227 KB of shared memory."""
    if plan.grouped and not (rows_groupable(plan.kc, cp, width)
                             and plan.tw * stride % (128 // cp) == 0):
        raise ValueError('conv_s8: box rows of Cp {} at width {} cannot be '
                         'grouped into 128 bytes'.format(cp, width))
    layout = conv_layout(plan, kernel_size, stride, padding, cp, out_bf16)
    if max(layout.box_cols, layout.box_rows) > TMA_BOX_LIMIT \
            or layout.smem > SMEM_LIMIT:
        raise ValueError('conv_s8: tile plan {} does not fit a TMA box and '
                         'shared memory at stride {}, Cp {}'.format(
                             tuple(plan), stride, cp))
    return layout


@functools.lru_cache(maxsize=None)
def _planned(n, h, w, cp, co, kernel_size, stride, padding, out_bf16):
    plan = plan_conv_tiles(n, h, w, cp, co, kernel_size, stride, padding,
                           out_bf16)
    return plan, check_conv_plan(plan, kernel_size, stride, padding, cp, w,
                                 out_bf16)


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
    if x.numel() == 0 or (scale.numel() > 1 and c > _QUANT_MAX_CHANNELS):
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
            channels=None, groups=1, out_dtype=torch.bfloat16, plan=None):
    """int8 x int8 -> int32 convolution with the dequantizing epilogue,
    in one launch.

    Args:
        xq: s8 ``[N, H, W, Cp]`` (``quantize_s8``), the pad channels 0.
        w: s8 ``[Co, k*k*Kc]`` (``pack_weight_s8``); on the card, for
            ``groups > 1``, also the dense ``[Co, k*k*Cp]`` of
            ``expand_grouped_weight_s8``.
        sw: f32 ``[Co]``; bias: f32 ``[Co]`` or None.
        kernel_size, stride, padding: square kernel, symmetric padding.
        channels: the logical input channels (``Cp`` by default).
        groups: grouped conv; on the card one dense launch over
            block-diagonal weights.
        out_dtype: float32 or bfloat16.
        plan: a ``ConvPlan`` for the card in place of
            ``plan_conv_tiles``'s (to compare plans); it raises where it
            does not fit (``check_conv_plan``).
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
    n, h, wd, cp = xq.shape
    co, k = w.shape[0], kernel_size
    cin = cp if channels is None else channels
    if groups != 1:
        if cin % groups or co % groups:
            raise ValueError('conv_s8: {} input and {} output channels in {} '
                             'groups'.format(cin, co, groups))
        if w.shape[1] == k * k * (cin // groups):
            w = expand_grouped_weight_s8(w, k, cp, cin, groups)
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
    out_bf16 = out_dtype == torch.bfloat16
    if plan is None:
        plan, layout = _planned(n, h, wd, cp, co, k, stride, padding,
                                out_bf16)
    else:
        layout = check_conv_plan(plan, k, stride, padding, cp, wd, out_bf16)
    y = torch.empty((n, co, ho, wo), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        _launch('conv_s8', xq.data_ptr(), w.data_ptr(), sw.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(), n,
                h, wd, cp, co, ho, wo, k, stride, padding,
                int(out_bf16), *plan[:5], int(plan.grouped), *layout)
    return y
