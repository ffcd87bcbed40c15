"""bpbreid_tpu_torch ops vs bpbreid_tpu: resize, tensortools, pooling and
the plain version of the fused attention-pool kernel (K2).

Tolerances: f32 ops 1e-5..1e-4 absolute (sums in another order);
bf16 inputs 1e-2 relative (one bf16 rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.ops import pooling as jpool
from bpbreid_tpu.ops import resize as jresize
from bpbreid_tpu.ops import tensortools as jtt
from bpbreid_tpu.ops.pallas.pooling import fused_attention_pool as j_fused
from bpbreid_tpu_torch.ops import pooling as tpool
from bpbreid_tpu_torch.ops import resize as tresize
from bpbreid_tpu_torch.ops import tensortools as ttt
from bpbreid_tpu_torch.ops.cuda import pooling as tcuda
from tests.torch_port_helpers import nchw, to_nhwc, to_np, limit_torch_threads

limit_torch_threads()


@pytest.mark.parametrize('in_hw,out_hw', [((16, 8), (4, 2)), ((6, 5), (13, 7)),
                                          ((96, 32), (24, 8))])
def test_resize_nearest_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).normal(size=(2, *in_hw, 3)).astype(np.float32)
    want = jresize.resize_nearest(jnp.asarray(x), *out_hw)
    got = tresize.resize_nearest(nchw(x), *out_hw)
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))


@pytest.mark.parametrize('in_hw,out_hw', [((12, 4), (96, 32)), ((24, 8), (96, 32)),
                                          ((7, 5), (7, 5)), ((9, 6), (4, 3)),
                                          ((1, 3), (5, 1))])
def test_resize_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(1).normal(size=(2, *in_hw, 4)).astype(np.float32)
    want = jresize.resize_bilinear_align_corners(jnp.asarray(x), *out_hw)
    got = tresize.resize_bilinear_align_corners(nchw(x), *out_hw)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        tresize._linear_matrix_align_corners(in_hw[0], out_hw[0]),
        jresize._linear_matrix_align_corners(in_hw[0], out_hw[0]))


def test_resize_bilinear_bf16_promotes_to_f32_like_jax():
    """The JAX version multiplies by f32 matrices, so a bf16 map comes
    back f32; the port returns f32 too (the HRNet concat map relies on
    it)."""
    x = np.random.default_rng(2).normal(size=(1, 6, 4, 3)).astype(np.float32)
    want = jresize.resize_bilinear_align_corners(
        jnp.asarray(x, jnp.bfloat16), 12, 8)
    got = tresize.resize_bilinear_align_corners(
        nchw(x).to(torch.bfloat16), 12, 8)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6)


def test_tensortools_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 4, 3)).astype(np.float32)
    bmask = rng.uniform(size=(5, 4, 3)) > 0.5
    bmask[:, 0, 0] = False                      # an all-invalid column
    fmask = rng.uniform(size=(5, 4, 3)).astype(np.float32) * bmask
    for mask in (bmask, fmask):
        want = jtt.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=0)
        got = ttt.masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                              dim=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jtt.replace_values(jnp.asarray(x), jnp.asarray(bmask), -1.0)
    got = ttt.replace_values(torch.from_numpy(x), torch.from_numpy(bmask),
                             -1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('pooling', ['gwap', 'gap', 'gmp'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_parts_pooling_matches_jax(pooling, dtype):
    rng = np.random.default_rng(4)
    f = rng.normal(size=(2, 6, 4, 40)).astype(np.float32)
    m = rng.uniform(size=(2, 6, 4, 5)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jpool.parts_pooling(jnp.asarray(f, jdt), jnp.asarray(m, jdt),
                               pooling)
    got = tpool.parts_pooling(nchw(f).to(tdt), nchw(m).to(tdt), pooling)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    w = to_np(want)
    tol = 1e-5 if dtype == 'float32' else 1e-2 * np.abs(w).max()
    np.testing.assert_allclose(to_np(got), w, atol=tol)


@pytest.mark.parametrize('shape', [(2, 8, 4, 96, 6), (3, 7, 1, 40, 3),
                                   (1, 5, 3, 100, 37)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_pool_plain_matches_jax_kernel(shape, dtype):
    """K2's plain version (the CPU path of fused_attention_pool) against
    the Pallas kernel in interpret mode and its own XLA branch."""
    n, h, w, d, k1 = shape
    rng = np.random.default_rng(5)
    f = rng.normal(size=(n, h, w, d)).astype(np.float32)
    lg = (3 * rng.normal(size=(n, h, w, k1))).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jf, jl = jnp.asarray(f, jdt), jnp.asarray(lg, jdt)
    want_x = j_fused(jf, jl, use_pallas=False)
    want_k = j_fused(jf, jl, d_tile=d, interpret=True)
    got = tcuda.fused_attention_pool(nchw(f).to(tdt), nchw(lg).to(tdt))
    for name, g, wx, wk in zip(('num', 'den', 'vismax'), got, want_x,
                               want_k):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wx), atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=1e-4,
                                   err_msg=name)


def test_attention_pool_gwap_equivalence():
    """num/den equals GWAP pooling of the softmax maps (as
    tests/test_pallas_kernels.py checks for the JAX kernel)."""
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.normal(size=(2, 40, 4, 4)).astype(np.float32))
    lg = torch.from_numpy(rng.normal(size=(2, 3, 4, 4)).astype(np.float32))
    num, den, _ = tcuda.fused_attention_pool(f, lg)
    want = tpool.gwap_pool(f, torch.softmax(lg, dim=1))
    torch.testing.assert_close(num / den.clamp(min=1e-6)[..., None], want,
                               atol=1e-5, rtol=0)


def test_attention_pool_rejects_bad_inputs():
    f = torch.zeros(2, 8, 4, 4)
    with pytest.raises(ValueError):
        tcuda.fused_attention_pool(f, torch.zeros(2, 3, 4, 5))
    with pytest.raises(ValueError):
        tcuda.fused_attention_pool(f, torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        tcuda.fused_attention_pool(torch.zeros(2, 0, 4, 4),
                                   torch.zeros(2, 3, 4, 4))
