"""The ops under HACNN and beside it, of bpbreid_tpu_torch against the
JAX package's, f32 on the CPU:

- ``ops/grid_sample.py affine_grid_sample`` (``F.affine_grid`` +
  ``F.grid_sample``) against JAX's four gathers, with grid points inside,
  on the edge of and outside the map: the samples and the gradients with
  respect to the map and to ``theta`` to 1e-5 of their largest magnitude;
- ``ops/compact_bilinear_pooling.py``: the same hash and signs from the
  same numpy seed, the count sketch, the pooled output of two signals and
  of one, and the gradient, to 1e-5;
- NASNet's pools: the zero row and column at the top and left and the
  crop (``_max_pool_pad``, ``_avg_pool_pad``: the windows shifted by a
  pixel) and the padding-excluding average (``_avg_excl``), on negative
  inputs at odd and even sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.models import nasnet as jnasnet
from bpbreid_tpu.ops import compact_bilinear_pooling as jcbp
from bpbreid_tpu.ops.grid_sample import \
    affine_grid_sample as jax_affine_grid_sample
from bpbreid_tpu_torch.models import nasnet as tnasnet
from bpbreid_tpu_torch.models.zoo import avg_pool_excl
from bpbreid_tpu_torch.ops import compact_bilinear_pooling as tcbp
from bpbreid_tpu_torch.ops.grid_sample import affine_grid_sample
from tests.torch_port_helpers import (assert_close, limit_torch_threads,
                                      nchw, to_nhwc, zoo_images)

limit_torch_threads()


def _thetas(seed, n):
    """HACNN-like thetas (``[[1, 0, tx], [0, 0.25, ty]]``) with the
    translations pushing part of the grid off the map, and general ones."""
    rng = np.random.default_rng(seed)
    theta = np.zeros((n, 2, 3), np.float32)
    theta[:, 0, 0], theta[:, 1, 1] = 1.0, 0.25
    theta[:, :, 2] = rng.uniform(-1.2, 1.2, (n, 2))
    theta[n // 2:, :, :2] = rng.uniform(-1.5, 1.5, (n - n // 2, 2, 2))
    return theta


@pytest.mark.parametrize('out_hw', [None, (5, 9)])
def test_affine_grid_sample_matches_jax(out_hw):
    """Samples, and the gradients of a weighted sum of them with respect
    to the map and to ``theta``."""
    x = zoo_images(0, 6, 8, 12, 3)
    theta = _thetas(1, 6)
    oh, ow = out_hw or (None, None)
    weights = np.random.default_rng(2).standard_normal(
        (6,) + (out_hw or (8, 12)) + (3,)).astype(np.float32)

    def jax_loss(x, theta):
        return (jax_affine_grid_sample(x, theta, oh, ow) * weights).sum()
    want = jax_affine_grid_sample(jnp.asarray(x), jnp.asarray(theta), oh, ow)
    want_dx, want_dtheta = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(theta))
    tx = nchw(x).requires_grad_(True)
    ttheta = torch.from_numpy(theta).requires_grad_(True)
    got = affine_grid_sample(tx, ttheta, oh, ow)
    (got * nchw(weights)).sum().backward()
    assert_close(to_nhwc(got), want, 1e-5)
    assert_close(to_nhwc(tx.grad), want_dx, 1e-5)
    assert_close(ttheta.grad, want_dtheta, 1e-5)


def test_compact_bilinear_pooling_matches_jax():
    """The sketch parameters from ``numpy.random.default_rng(seed)``, the
    count sketch (``index_add``) and the pooled output (rfft, product,
    irfft) of two signals and of one, and the gradient."""
    d1, d2, out = 24, 20, 32
    x = zoo_images(3, 3, 2, 1, d1)[:, :, 0]             # [3, 2, d1]
    y = zoo_images(4, 3, 2, 1, d2)[:, :, 0]
    jpool = jcbp.CompactBilinearPooling(d1, d2, out, seed=5)
    tpool = tcbp.CompactBilinearPooling(d1, d2, out, seed=5, device='cpu')
    for j, t in ((jpool.hx, tpool.hx), (jpool.sx, tpool.sx),
                 (jpool.hy, tpool.hy), (jpool.sy, tpool.sy)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    sketch = tcbp.CountSketch(d1, out, seed=5, device='cpu')
    assert_close(sketch(torch.from_numpy(x)),
                 jcbp.CountSketch(d1, out, seed=5)(jnp.asarray(x)), 1e-5)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tpool(tx, torch.from_numpy(y))
    assert_close(got, jpool(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    got.pow(2).sum().backward()
    want_dx = jax.grad(lambda a: (jpool(a, jnp.asarray(y)) ** 2).sum())(
        jnp.asarray(x))
    assert_close(tx.grad, want_dx, 1e-5)
    square = tcbp.CompactBilinearPooling(d1, d1, out, seed=6, device='cpu')
    assert_close(square(torch.from_numpy(x)),
                 jcbp.CompactBilinearPooling(d1, d1, out, seed=6)(
                     jnp.asarray(x)), 1e-5)


def test_sketch_parameters_default_to_the_card(monkeypatch):
    """Without a device the sketch goes to ``'cuda'``, raising without
    one."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tcbp.CompactBilinearPooling(8, 8, 16)


@pytest.mark.parametrize('h, w', [(7, 5), (8, 6), (2, 3)])
def test_nasnet_pools_match_jax(h, w):
    x = zoo_images(h + w, 2, h, w, 3) - 4.0
    jx, tx = jnp.asarray(x), nchw(x)
    assert_close(to_nhwc(tnasnet._max_pool_pad(tx)),
                 jnasnet._max_pool_pad(jx), 0)
    assert_close(to_nhwc(tnasnet._avg_pool_pad(tx)),
                 jnasnet._avg_pool_pad(jx), 1e-6)
    for stride in (1, 2):
        assert_close(to_nhwc(avg_pool_excl(tx, 3, stride, 1)),
                     jnasnet._avg_excl(jx, 3, stride, 1), 1e-6)
