"""Fused eval BasicBlock chain, BN folded (port of the Pallas TPU kernel
bpbreid_tpu/ops/pallas/conv_chain.py:86).

Per block i of ``len(weights) // 2``:

  y = relu(conv3x3(x) * s[2i] + b[2i])
  y = conv3x3(y) * s[2i+1] + b[2i+1]
  x = relu(x + y)

on an ``[N, H, W, C]`` map (an NCHW map in ``torch.channels_last`` memory
format gives that view with ``x.permute(0, 2, 3, 1)``, no copy), HWIO
weights ``[2B, 3, 3, C, C]`` and f32 ``[2B, C]`` scales and biases. f32
products and sums; x stays f32 across the blocks and is cast to
``x.dtype`` after the last one.

``fused_basicblock_chain`` launches the CUDA kernel (``cuda/conv_chain.cu``,
one launch per block) for CUDA tensors and raises if it cannot; it runs
the plain version ``basicblock_chain_reference`` only for tensors that lie
on the CPU. ``fold_basicblock_chain`` turns an eval ``ResLayer`` of
``BasicBlock``s into the kernel's operands. No model path calls the chain:
the JAX package exposes it as an op and wires it into no model.
"""
import torch
import torch.nn.functional as F

from bpbreid_tpu_torch.models.common import BasicBlock
from bpbreid_tpu_torch.ops.cuda.build import (check_cuda_error, launch_counts,
                                              load_kernel)

__all__ = ['fused_basicblock_chain', 'basicblock_chain_reference',
           'fold_basicblock_chain', 'plan_tiles']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory a block may take (H100: 227 KB) and the share the tile
# planner aims at, so that two blocks fit on one SM
SMEM_LIMIT = 232448
SMEM_TARGET = 112 * 1024
_MIN_BLOCKS = 264          # two per SM of an H100


def basicblock_chain_reference(x, weights, scales, biases):
    """Plain PyTorch version of the kernel (f32 convolutions)."""
    xf = x.float().permute(0, 3, 1, 2)                       # NCHW f32
    w = weights.float().permute(0, 4, 3, 1, 2)        # [2B, O, I, 3, 3]
    s = scales.float()[:, :, None, None]
    b = biases.float()[:, :, None, None]
    for i in range(weights.shape[0] // 2):
        y = F.conv2d(xf, w[2 * i], padding=1)
        y = torch.relu(y * s[2 * i] + b[2 * i])
        y = F.conv2d(y, w[2 * i + 1], padding=1)
        xf = torch.relu(xf + (y * s[2 * i + 1] + b[2 * i + 1]))
    return xf.permute(0, 2, 3, 1).to(x.dtype)


@torch.no_grad()
def fold_basicblock_chain(res_layer):
    """``(weights [2B, 3, 3, C, C], scales [2B, C], biases [2B, C])`` of a
    ``ResLayer`` of ``BasicBlock``s in eval mode: conv weights as HWIO,
    each BN folded to ``s = gamma / sqrt(var + eps)``, ``b = beta -
    mean * s``, all f32."""
    weights, scales, biases = [], [], []
    for block in res_layer:
        if not isinstance(block, BasicBlock) or block.downsample is not None:
            raise ValueError('fold_basicblock_chain takes BasicBlocks '
                             'without downsample, got {}'.format(
                                 type(block).__name__))
        for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2)):
            if conv.stride != 1 or conv.groups != 1 or conv.bias is not None:
                raise ValueError('a 3x3 stride-1 conv without bias expected')
            s = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                + bn.eps)
            b = -bn.running_mean.float() * s
            if bn.bias is not None:
                b = b + bn.bias.float()
            weights.append(conv.weight.float().permute(2, 3, 1, 0))
            scales.append(s)
            biases.append(b)
    return torch.stack(weights), torch.stack(scales), torch.stack(biases)


def _smem_bytes(th, tw, cp):
    return ((th + 4) * (tw + 4) + (th + 2) * (tw + 2)) * cp * 4


def plan_tiles(n, h, w, cp):
    """Tile ``(rows, cols)`` of one kernel block: the whole width and as
    many rows as fit in ``SMEM_TARGET`` bytes of shared memory, then fewer
    rows while the grid has under ``_MIN_BLOCKS`` blocks (down to 4 rows).
    Raises when even one pixel's halo does not fit in ``SMEM_LIMIT``."""
    if _smem_bytes(1, 1, cp) > SMEM_LIMIT:
        raise ValueError('C={} too wide for the kernel\'s shared memory'
                         .format(cp))
    tw = w
    while tw > 1 and _smem_bytes(1, tw, cp) > SMEM_TARGET:
        tw = -(-tw // 2)
    th = h
    while th > 1 and _smem_bytes(th, tw, cp) > SMEM_TARGET:
        th -= 1

    def blocks(rows):
        return n * -(-h // rows) * -(-w // tw)

    while th > 4 and blocks(th) < _MIN_BLOCKS:
        th = -(-th // 2)
    return th, tw


def _check(x, weights, scales, biases):
    if x.dim() != 4:
        raise ValueError('expected x [N, H, W, C], got {}'.format(
            tuple(x.shape)))
    c = x.shape[3]
    n_convs = weights.shape[0]
    if n_convs == 0 or n_convs % 2 or tuple(weights.shape[1:]) != (3, 3, c, c):
        raise ValueError('expected weights [2B, 3, 3, {0}, {0}], got {1}'
                         .format(c, tuple(weights.shape)))
    for name, t in (('scales', scales), ('biases', biases)):
        if tuple(t.shape) != (n_convs, c):
            raise ValueError('expected {} [{}, {}], got {}'.format(
                name, n_convs, c, tuple(t.shape)))
    if any(t.device != x.device for t in (weights, scales, biases)):
        raise ValueError('inputs lie on different devices')
    if x.numel() == 0:
        raise ValueError('empty input')


def fused_basicblock_chain(x, weights, scales, biases):
    """Run ``len(weights) // 2`` BasicBlocks over ``x``.

    Args:
        x: ``[N, H, W, C]`` float32 or bfloat16, contiguous in that view.
        weights: ``[2B, 3, 3, C, C]`` HWIO conv kernels.
        scales, biases: ``[2B, C]`` folded-BN affine parameters.
    Returns:
        ``[N, H, W, C]`` of ``x.dtype``.
    """
    _check(x, weights, scales, biases)
    if x.device.type == 'cpu':
        return basicblock_chain_reference(x, weights, scales, biases)
    if x.device.type != 'cuda':
        raise ValueError('unsupported device {}'.format(x.device))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError('x must be float32 or bfloat16, got {}'.format(
            x.dtype))
    if not x.is_contiguous():
        raise ValueError('x must be contiguous as [N, H, W, C] (an NCHW map '
                         'in channels_last memory format, permuted)')
    n, h, w, c = x.shape
    n_blocks = weights.shape[0] // 2
    cp = -(-c // 4) * 4
    # output channels per lane and pass: the power of two >= Cp / 32, <= 8
    tc = min(8, 1 << max(0, (-(-cp // 32) - 1).bit_length()))
    th, tw = plan_tiles(n, h, w, cp)
    # zero-padded to Cp channels: [2B, 9, Cp, Cp] (tap, ci, co), [2B, Cp]
    pad = cp - c
    wm = F.pad(weights.float().reshape(2 * n_blocks, 9, c, c),
               (0, pad, 0, pad)).contiguous()
    sp = F.pad(scales.float(), (0, pad)).contiguous()
    bp = F.pad(biases.float(), (0, pad)).contiguous()
    out = torch.empty_like(x)
    bufs = [torch.empty((n, h, w, c), dtype=torch.float32, device=x.device)
            if n_blocks > k + 1 else None for k in range(2)]
    lib, fn = load_kernel('conv_chain')
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(),
                  *(0 if t is None else t.data_ptr() for t in bufs),
                  wm.data_ptr(), sp.data_ptr(), bp.data_ptr(), n, h, w, c, cp,
                  n_blocks, th, tw, tc, _DTYPE_CODES[x.dtype],
                  torch.cuda.current_stream().cuda_stream)
    check_cuda_error(lib, code, 'conv_chain kernel')
    launch_counts['conv_chain'] += n_blocks
    return out
