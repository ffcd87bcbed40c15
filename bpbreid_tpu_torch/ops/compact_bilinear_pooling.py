"""Compact bilinear pooling, by count sketch and FFT (port of
bpbreid_tpu/ops/compact_bilinear_pooling.py).

The bilinear (outer-product) pooling of two feature vectors is
approximated by the circular convolution of their count sketches,
computed in the frequency domain: ``irfft(rfft(sketch(x)) *
rfft(sketch(y)))``. The count sketch is an ``index_add_`` over the last
axis. No model calls it (in JAX either). The hash ``h`` and signs ``s``
are drawn with ``numpy.random.default_rng(seed)`` as JAX draws them, so
the same seed gives the same sketch in both packages. The sketch
parameters go to ``device``, ``'cuda'`` unless the caller names another
(raising without CUDA).
"""
import numpy as np
import torch

from bpbreid_tpu_torch import resolve_device

__all__ = ['make_sketch_params', 'count_sketch', 'compact_bilinear_pooling',
           'CountSketch', 'CompactBilinearPooling']


def make_sketch_params(input_size, output_size, seed=0, device=None):
    """The random hash ``h`` (int64, in ``[0, output_size)``) and signs
    ``s`` (+-1, f32) of a count sketch (JAX :20)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, output_size, input_size)
    s = 2.0 * rng.integers(0, 2, input_size) - 1.0
    device = resolve_device(device)
    return (torch.as_tensor(h, dtype=torch.int64, device=device),
            torch.as_tensor(s, dtype=torch.float32, device=device))


def count_sketch(x, h, s, output_size):
    """``out[..., h[i]] += s[i] * x[..., i]`` over the last axis (JAX
    :28); differentiable in ``x``."""
    xs = x * s.to(x.dtype)
    out = xs.new_zeros(x.shape[:-1] + (output_size,))
    return out.index_add(-1, h, xs)


def compact_bilinear_pooling(x, y, hx, sx, hy, sy, output_size):
    """CBP of two ``[..., D]`` signals -> ``[..., output_size]`` (JAX
    :37)."""
    fx = torch.fft.rfft(count_sketch(x, hx, sx, output_size), dim=-1)
    fy = torch.fft.rfft(count_sketch(y, hy, sy, output_size), dim=-1)
    return torch.fft.irfft(fx * fy, n=output_size, dim=-1)


class CountSketch:
    """(JAX :47)"""

    def __init__(self, input_size, output_size, seed=0, h=None, s=None,
                 device=None):
        self.input_size, self.output_size = input_size, output_size
        if h is None or s is None:
            h, s = make_sketch_params(input_size, output_size, seed, device)
        self.h, self.s = h, s

    def __call__(self, x):
        return count_sketch(x, self.h, self.s, self.output_size)


class CompactBilinearPooling:
    """(JAX :61) The second signal's sketch is drawn from ``seed + 1``."""

    def __init__(self, input1_size, input2_size, output_size, seed=0,
                 device=None):
        self.output_size = output_size
        self.hx, self.sx = make_sketch_params(input1_size, output_size, seed,
                                              device)
        self.hy, self.sy = make_sketch_params(input2_size, output_size,
                                              seed + 1, device)

    def __call__(self, x, y=None):
        y = x if y is None else y
        return compact_bilinear_pooling(x, y, self.hx, self.sx, self.hy,
                                        self.sy, self.output_size)
