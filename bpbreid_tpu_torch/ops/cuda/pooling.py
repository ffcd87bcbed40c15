"""Fused part-attention softmax + masked pooling (port of the Pallas
TPU kernel bpbreid_tpu/ops/pallas/pooling.py:47).

  probs  = softmax(logits, over K+1)       per pixel, f32
  num    = probs^T @ feats                 [N, K+1, D] f32
  den    = sum_p probs                     [N, K+1]    f32
  vismax = max_p probs                     [N, K+1]    f32

Channel-first inputs: ``features [N, D, H, W]`` and ``logits
[N, K+1, H, W]``, each float32 or bfloat16 and contiguous (the layout
the port's HRNet and pixel classifier produce). The outputs keep the
JAX kernel's ``(num, den, vismax)`` f32 contract.

``fused_attention_pool`` launches the CUDA kernel
(``attention_pool.cu``) for CUDA tensors and raises if it cannot; it
runs the plain version ``attention_pool_reference`` only for tensors
that lie on the CPU. The kernel has no backward (nor has the JAX
package's): on the card it raises when an input requires grad, rather
than return outputs cut from the graph. On the CPU the plain version is
differentiable, as the JAX one is.
"""
import torch

from bpbreid_tpu_torch.ops.cuda.build import (check_cuda_error, launch_counts,
                                              load_kernel)

__all__ = ['fused_attention_pool', 'attention_pool_reference']

MAX_PARTS = 64          # K+1 the kernel's register accumulators cover
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_pool_reference(features, logits):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    n, d = features.shape[:2]
    k1 = logits.shape[1]
    probs = torch.softmax(logits.reshape(n, k1, -1).float(), dim=1)
    num = torch.einsum('nkp,ndp->nkd', probs,
                       features.reshape(n, d, -1).float())
    return num, probs.sum(dim=-1), probs.amax(dim=-1)


def _check(features, logits):
    if features.dim() != 4 or logits.dim() != 4:
        raise ValueError('expected features [N, D, H, W] and logits '
                         '[N, K+1, H, W], got {} and {}'.format(
                             tuple(features.shape), tuple(logits.shape)))
    n, d, h, w = features.shape
    if logits.shape[0] != n or tuple(logits.shape[2:]) != (h, w):
        raise ValueError('features {} and logits {} disagree on N, H, W'
                         .format(tuple(features.shape), tuple(logits.shape)))
    if features.device != logits.device:
        raise ValueError('features and logits lie on different devices')
    if min(n, d, h * w, logits.shape[1]) == 0:
        raise ValueError('empty input')


def fused_attention_pool(features, logits):
    """Fused softmax-attention pooling.

    Args:
        features: ``[N, D, H, W]`` float32 or bfloat16.
        logits: ``[N, K+1, H, W]`` pixel part logits, float32 or bfloat16.
    Returns:
        ``(num [N, K+1, D], den [N, K+1], vismax [N, K+1])``, all f32.
    """
    _check(features, logits)
    if features.device.type == 'cpu':
        return attention_pool_reference(features, logits)
    if features.device.type != 'cuda':
        raise ValueError('unsupported device {}'.format(features.device))
    if torch.is_grad_enabled() and (features.requires_grad
                                    or logits.requires_grad):
        raise RuntimeError(
            'fused_attention_pool (K2) has no backward yet: its CUDA kernel '
            'would cut the gradients into the features and the pixel '
            'classifier. Train with multires pooling or '
            'use_pallas_pooling=False')
    n, d, h, w = features.shape
    k1 = logits.shape[1]
    if features.dtype not in _DTYPE_CODES or logits.dtype not in _DTYPE_CODES:
        raise TypeError('features/logits must be float32 or bfloat16, got '
                        '{}/{}'.format(features.dtype, logits.dtype))
    if not (features.is_contiguous() and logits.is_contiguous()):
        raise ValueError('features and logits must be contiguous '
                         '(channel-first)')
    if k1 > MAX_PARTS:
        raise ValueError('K+1={} exceeds the kernel limit {}'.format(
            k1, MAX_PARTS))
    if n > 65535:
        raise ValueError('batch {} exceeds the kernel grid limit 65535'
                         .format(n))
    lib, fn = load_kernel('attention_pool')
    num = torch.empty((n, k1, d), dtype=torch.float32, device=features.device)
    den = torch.empty((n, k1), dtype=torch.float32, device=features.device)
    vismax = torch.empty_like(den)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(features.data_ptr(), logits.data_ptr(), num.data_ptr(),
                  den.data_ptr(), vismax.data_ptr(), n, d, h * w, k1,
                  _DTYPE_CODES[features.dtype], _DTYPE_CODES[logits.dtype],
                  stream)
    check_cuda_error(lib, code, 'attention_pool kernel')
    launch_counts['attention_pool'] += 1
    return num, den, vismax
