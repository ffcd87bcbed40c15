"""Affine grid sampling, the spatial transformer of HACNN's hard
attention (port of bpbreid_tpu/ops/grid_sample.py).

``F.affine_grid`` + ``F.grid_sample`` with torch's defaults (bilinear,
zero padding, ``align_corners=False``), which JAX writes out as four
gathers; computed in f32 and returned in ``x``'s dtype. Differentiable in
``x`` and ``theta``.
"""
import torch.nn.functional as F

__all__ = ['affine_grid_sample']


def affine_grid_sample(x, theta, out_h=None, out_w=None):
    """Sample ``x`` ``[N, C, H, W]`` on the affine grid of ``theta``
    ``[N, 2, 3]`` (normalized coordinates, ``align_corners=False``);
    returns ``[N, C, out_h, out_w]`` (default: ``x``'s size)."""
    n, c, h, w = x.shape
    grid = F.affine_grid(theta.float(), [n, c, out_h or h, out_w or w],
                         align_corners=False)
    return F.grid_sample(x.float(), grid, mode='bilinear',
                         padding_mode='zeros',
                         align_corners=False).to(x.dtype)
