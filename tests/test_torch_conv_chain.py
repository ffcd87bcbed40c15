"""K1, the fused eval BasicBlock chain: the port's ``fused_basicblock_chain``
on CPU tensors (its plain version) against JAX ``basicblock_chain_reference``
and the Pallas kernel in interpret mode, on the same numpy inputs.

f32: 1e-4 (f32 convolutions summed in another order). bf16 input: the
chain runs in f32 and rounds once at the end, so the outputs agree to 2
bf16 ulps of each value, plus 1e-5 of the largest one for values that
the f32 noise moves across a ReLU's zero. The fold of an eval
``ResLayer(BasicBlock)`` into the chain's operands equals the layer to
1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.ops.pallas import conv_chain as j_conv_chain
from bpbreid_tpu_torch.models.common import BasicBlock, ResLayer
from bpbreid_tpu_torch.ops.conv_chain import (basicblock_chain_reference,
                                              fold_basicblock_chain,
                                              fused_basicblock_chain,
                                              plan_tiles)
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
    got = fused_basicblock_chain(tx, *map(torch.from_numpy, (w, s, b)))
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
    from bpbreid_tpu_torch.ops.conv_chain import SMEM_LIMIT, _smem_bytes
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
