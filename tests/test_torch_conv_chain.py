"""K1, the fused eval BasicBlock chain: the port's plain versions against
JAX ``basicblock_chain_reference`` and the Pallas kernel in interpret
mode, on the same numpy inputs; the bf16 kernel's operand layout (weight
repack, GEMM view) and tile planner, which run on the CPU.

f32 contract (``basicblock_chain_reference``): 1e-4 (f32 convolutions
summed in another order); on a bf16 input it runs in f32 and rounds once
at the end, so the outputs agree to 2 bf16 ulps of each value, plus 1e-5
of the largest one for values that the f32 noise moves across a ReLU's
zero. bf16 contract (``basicblock_chain_bf16_reference``, what
``fused_basicblock_chain`` computes for a bf16 input): its operands are
rounded to bf16, so against JAX's f32 convs it agrees to a rel. L2 of
1e-2. The fold of an eval ``ResLayer(BasicBlock)`` into the chain's
operands equals the layer to 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.ops.pallas import conv_chain as j_conv_chain
from bpbreid_tpu_torch.models.common import BasicBlock, ResLayer
from bpbreid_tpu_torch.ops.conv_chain import (
    MMA_MIN_CTAS, SMEM_LIMIT, basicblock_chain_bf16_reference,
    basicblock_chain_reference, fold_basicblock_chain, fused_basicblock_chain,
    mma_smem_bytes, plan_mma_tiles, plan_tiles, repack_weights_bf16)
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def _inputs(shape, blocks, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(2 * blocks, 3, 3, c, c)) * 0.05).astype(np.float32)
    s = (rng.normal(size=(2 * blocks, c)) * 0.1 + 1).astype(np.float32)
    b = (rng.normal(size=(2 * blocks, c)) * 0.1).astype(np.float32)
    return x, w, s, b


def _bf16_ulp(v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize('shape,blocks', [((2, 8, 4, 32), 2),
                                          ((1, 5, 3, 8), 1)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_chain_matches_jax(shape, blocks, dtype):
    x, w, s, b = _inputs(shape, blocks)
    jx = jnp.asarray(x).astype(dtype)
    want_ref = j_conv_chain.basicblock_chain_reference(jx, w, s, b)
    want_pallas = j_conv_chain.fused_basicblock_chain(jx, w, s, b,
                                                      interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = basicblock_chain_reference(tx, *map(torch.from_numpy, (w, s, b)))
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    got = got.float().numpy()
    for want in (want_ref, want_pallas):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == 'float32':
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        else:
            tol = 2 * _bf16_ulp(want) + 1e-5 * np.abs(want).max()
            assert (np.abs(got - want) <= tol).all()


def test_fold_of_a_res_layer_equals_the_layer():
    layer = ResLayer(BasicBlock, 32, 32, 2).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (0.05 if p.dim() == 4 else 0.1))
        for m in layer.modules():
            if hasattr(m, 'running_var'):
                m.weight.add_(1.0)
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        x = torch.randn((2, 32, 8, 4), generator=gen)
        want = layer(x)
    weights, scales, biases = fold_basicblock_chain(layer)
    assert tuple(weights.shape) == (4, 3, 3, 32, 32)
    assert tuple(scales.shape) == tuple(biases.shape) == (4, 32)
    # channels_last NCHW viewed as NHWC without a copy
    x_cl = x.contiguous(memory_format=torch.channels_last)
    x_nhwc = x_cl.permute(0, 2, 3, 1)
    assert x_nhwc.is_contiguous() and x_nhwc.data_ptr() == x_cl.data_ptr()
    got = basicblock_chain_reference(x_nhwc, weights, scales, biases)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError):
        fold_basicblock_chain(ResLayer(BasicBlock, 16, 32, 1))


def test_tile_plan_fits_shared_memory():
    """The tiles of the main-path chains and of ragged maps fit the
    kernel's shared memory, and the wrapper refuses malformed operands."""
    from bpbreid_tpu_torch.ops.conv_chain import _smem_bytes
    for n, h, w, cp in ((64, 96, 32, 32), (64, 48, 16, 64), (64, 24, 8, 128),
                        (64, 12, 4, 256), (1, 5, 3, 8), (2, 1, 1, 32),
                        (3, 7, 5, 36), (1, 4, 5000, 64)):
        th, tw = plan_tiles(n, h, w, cp)
        assert 1 <= th <= h and 1 <= tw <= w
        assert _smem_bytes(th, tw, cp) <= SMEM_LIMIT
    with pytest.raises(ValueError):
        plan_tiles(1, 1, 1, 4096)
    x, w, s, b = map(torch.from_numpy, _inputs((1, 5, 3, 8), 1))
    with pytest.raises(ValueError):
        fused_basicblock_chain(x, w[:1], s[:1], b[:1])      # odd conv count
    with pytest.raises(ValueError):
        fused_basicblock_chain(x, w, s[:, :4], b)


# K1's main-path shapes [N, H, W, C] (HRNet-W32's branch chains at
# 384x128, N=64) and ragged ones
K1_MAIN = [(64, 96, 32, 32), (64, 48, 16, 64), (64, 24, 8, 128),
           (64, 12, 4, 256)]
K1_RAGGED = [(1, 5, 3, 8), (2, 1, 1, 32), (2, 2, 1, 32), (3, 7, 5, 33),
             (2, 3, 4, 48), (1, 4, 5000, 64)]


@pytest.mark.parametrize('shape,blocks', [((2, 8, 4, 32), 2),
                                          ((1, 5, 3, 8), 1),
                                          ((2, 6, 5, 33), 2)])
def test_bf16_plain_chain_matches_jax(shape, blocks):
    """The bf16 contract against JAX's reference on the same bf16 input
    (JAX convolves in f32): the bf16 weights, y1 and block inputs differ
    from f32 by up to 2^-9 of each value, which the sums average out to
    a rel. L2 of about 3e-3; 1e-2 as on the card."""
    x, w, s, b = _inputs(shape, blocks)
    jx = jnp.asarray(x).astype('bfloat16')
    want = np.asarray(j_conv_chain.basicblock_chain_reference(jx, w, s, b)
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = basicblock_chain_bf16_reference(
        tx, *map(torch.from_numpy, (w, s, b)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    got = got.float().numpy()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel_l2 <= 1e-2


@pytest.mark.parametrize('shape,blocks', [((2, 8, 4, 32), 2),
                                          ((3, 7, 5, 33), 2)])
def test_fused_chain_on_cpu_bf16_is_the_bf16_reference(shape, blocks):
    """On the CPU, a bf16 input runs the bf16 contract's plain version
    and an f32 input the f32 one, bit for bit."""
    x, w, s, b = map(torch.from_numpy, _inputs(shape, blocks))
    xb = x.to(torch.bfloat16)
    assert torch.equal(fused_basicblock_chain(xb, w, s, b),
                       basicblock_chain_bf16_reference(xb, w, s, b))
    assert torch.equal(fused_basicblock_chain(x, w, s, b),
                       basicblock_chain_reference(x, w, s, b))


def test_weight_repack_by_index():
    """HWIO [2B, 3, 3, C, C] -> bf16 [2B, Co_p, 9 Cp] at a ragged C, held
    by index against an explicit loop."""
    c, cp, cop = 5, 16, 8
    w = torch.from_numpy(_inputs((1, 1, 1, c), 1)[1])
    got = repack_weights_bf16(w, cp, cop)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, cop,
                                                                 9 * cp)
    want = torch.zeros((2, cop, 9 * cp), dtype=torch.bfloat16)
    for i in range(2):
        for co in range(c):
            for dy in range(3):
                for dx in range(3):
                    for ci in range(c):
                        want[i, co, (3 * dy + dx) * cp + ci] = \
                            w[i, dy, dx, ci, co].to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize('shape', [(2, 5, 4, 33), (1, 3, 6, 16)])
def test_gemm_view_of_the_repacked_weights_is_the_conv(shape):
    """The kernel's GEMM view: out[m, co] = sum_k A[m, k] B[co, k] with
    A[m, (3 dy + dx) Cp + ci] = a[n, h + dy - 1, w + dx - 1, ci] (0
    outside the image) and B the repacked weights, equals the 3x3 conv."""
    n, h, wd, c = shape
    cp, cop = -(-c // 16) * 16, -(-c // 8) * 8
    x, w, _, _ = map(torch.from_numpy, _inputs(shape, 1))
    a = torch.nn.functional.pad(x.to(torch.bfloat16).float(),
                                (0, cp - c, 1, 1, 1, 1))  # [N, H+2, W+2, Cp]
    cols = [a[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)]
    big_a = torch.cat(cols, dim=-1).reshape(n * h * wd, 9 * cp)
    big_b = repack_weights_bf16(w, cp, cop)[0].float()       # [Co_p, 9 Cp]
    got = (big_a @ big_b.T).reshape(n, h, wd, cop)
    assert (got[..., c:] == 0).all()
    want = torch.nn.functional.conv2d(
        x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
        w[0].to(torch.bfloat16).float().permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(got[..., :c], want.permute(0, 2, 3, 1),
                               atol=1e-4, rtol=0)


def test_mma_tile_plan():
    """The bf16 kernel's tiles: at least one CTA per SM of an H100 at the
    main-path shapes, and a ring of stages that fits the shared memory
    with room for two CTAs an SM, at the main and the ragged shapes."""
    for shape in K1_MAIN + K1_RAGGED:
        n, h, w, c = shape
        cp, cop = -(-c // 16) * 16, -(-c // 8) * 8
        bm, bn, kc = plan_mma_tiles(n * h * w, cp, cop)
        assert cp % kc == 0 and kc % 16 == 0 and bm % 32 == 0
        assert bn in (32, 64) and bn < cop + 32
        assert 2 * mma_smem_bytes(bm, bn, kc) <= SMEM_LIMIT
        if shape in K1_MAIN:
            assert -(-n * h * w // bm) * -(-cop // bn) >= MMA_MIN_CTAS
    assert plan_mma_tiles(64 * 12 * 4, 256, 256) == (64, 64, 64)
    assert plan_mma_tiles(64 * 96 * 32, 32, 32) == (128, 32, 32)
