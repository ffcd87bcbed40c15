"""Resize ops with exact torch corner conventions (port of
bpbreid_tpu/ops/resize.py).

Channel-first: spatial axes are the last two (``[..., H, W]``).

- nearest: source index = floor(dst * in/out) (torch legacy nearest);
- bilinear align_corners=True: products with the f32 interpolation
  matrices, as in the JAX version, which promotes bf16 inputs to f32,
  so this returns f32 for float inputs as well.
"""
import functools

import numpy as np
import torch

__all__ = ['resize_nearest', 'resize_bilinear_align_corners']


@functools.lru_cache(maxsize=128)
def _nearest_indices(in_size, out_size):
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest(x, out_h, out_w, spatial_axes=(-2, -1)):
    """Nearest-neighbor resize matching ``F.interpolate(mode='nearest')``."""
    ax_h, ax_w = spatial_axes
    ih, iw = x.shape[ax_h], x.shape[ax_w]
    idx_h = torch.as_tensor(_nearest_indices(ih, out_h), device=x.device)
    idx_w = torch.as_tensor(_nearest_indices(iw, out_w), device=x.device)
    return x.index_select(ax_h, idx_h).index_select(ax_w, idx_w)


@functools.lru_cache(maxsize=128)
def _linear_matrix_align_corners(in_size, out_size):
    """[out, in] interpolation weights for align_corners=True bilinear."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (src - lo).astype(np.float32)
    m[np.arange(out_size), lo] = 1.0 - frac
    m[np.arange(out_size), lo + 1] += frac
    return m


def linear_matrix_align_corners(in_size, out_size, device):
    """``_linear_matrix_align_corners`` as an f32 tensor on ``device``."""
    return torch.as_tensor(_linear_matrix_align_corners(in_size, out_size),
                           device=device)


def resize_bilinear_align_corners(x, out_h, out_w):
    """Bilinear resize with torch's ``align_corners=True`` semantics.

    As in the JAX version: the H axis, then the W axis, each a product
    with the f32 interpolation matrix. (``F.interpolate``'s channel-first
    CUDA kernel loops over every channel in each thread; on the HRNet
    concat it took 42 % of the forward on an H100.)

    Args:
        x: ``[..., H, W]``.
    Returns:
        ``[..., out_h, out_w]`` in f32 (``x`` itself when the size is
        unchanged, as in the JAX version).
    """
    ih, iw = x.shape[-2:]
    if (ih, iw) == (out_h, out_w):
        return x
    mh = linear_matrix_align_corners(ih, out_h, x.device)
    mw = linear_matrix_align_corners(iw, out_w, x.device)
    return torch.matmul(torch.matmul(mh, x.float()), mw.T)
