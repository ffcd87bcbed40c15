"""bpbreid_tpu_torch kernels on the card (marker ``cuda``; skipped
without a CUDA device). Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

The attention-pool kernel (K2) is held against its plain version on the
same CUDA inputs: f32 sums over the pixels in another order, so the
tolerance is 2e-5 of the largest output magnitude. The BN-sum kernels
(K3, forward and backward) sum in f64 and the plain version in f32: 1e-5
of the per-channel sum of magnitudes."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('shape', [(2, 40, 7, 1, 3), (3, 100, 96, 32, 37),
                                   (64, 1920, 96, 32, 6), (1, 7, 13, 11, 64)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attention_pool_kernel_matches_plain(cuda, shape, dtype):
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.ops.cuda.pooling import (attention_pool_reference,
                                                    fused_attention_pool)
    n, d, h, w, k1 = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    feats = torch.randn(n, d, h, w, device=cuda, generator=gen).to(dtype)
    logits = (3 * torch.randn(n, k1, h, w, device=cuda, generator=gen)) \
        .to(dtype)
    before = launch_counts['attention_pool']
    got = fused_attention_pool(feats, logits)
    torch.cuda.synchronize()
    assert launch_counts['attention_pool'] == before + 1
    for a, b in zip(got, attention_pool_reference(feats, logits)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        tol = 2e-5 * b.abs().max().item() + 1e-6
        assert (a - b).abs().max().item() <= tol


def test_attention_pool_kernel_refuses_bad_cuda_inputs(cuda):
    from bpbreid_tpu_torch.ops.cuda.pooling import fused_attention_pool
    feats = torch.zeros(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError):         # not contiguous: no copy made
        fused_attention_pool(feats.transpose(2, 3),
                             torch.zeros(2, 3, 4, 4, device=cuda))
    with pytest.raises(TypeError):
        fused_attention_pool(feats.half(), torch.zeros(2, 3, 4, 4,
                                                       device=cuda))
    with pytest.raises(ValueError):
        fused_attention_pool(feats, torch.zeros(2, 65, 4, 4, device=cuda))


def test_attention_pool_refuses_inputs_that_require_grad(cuda):
    """K2 has no backward: on the card it refuses to cut the graph."""
    from bpbreid_tpu_torch.ops.cuda.pooling import fused_attention_pool
    feats = torch.randn(2, 8, 4, 4, device=cuda, requires_grad=True)
    logits = torch.randn(2, 3, 4, 4, device=cuda)
    with pytest.raises(RuntimeError, match='no backward'):
        fused_attention_pool(feats, logits)
    with torch.no_grad():
        fused_attention_pool(feats, logits)


# K3: [A, C, B] views of the main path's shapes (NCHW and [M, C]) and
# ragged ones (odd C, odd H*W, A = 1)
K3_SHAPES = [((64, 32, 96, 32), 1), ((64, 256, 12, 4), 1), ((64, 512), -1),
             ((320, 512), -1), ((3, 7, 5, 3), 1), ((1, 33, 9, 7), 1),
             ((1, 5), -1), ((5, 3, 6), -1)]


def _k3_inputs(cuda, shape, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (0.5 + torch.randn(shape, device=cuda, generator=gen)).to(dtype)
    dy = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    return x, dy


def _k3_close(got, want, scales):
    """f64 sums in the kernel, f32 in the plain version: 1e-5 of the sum
    of magnitudes, per channel."""
    for a, b, s in zip(got, want, scales):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert ((a - b).abs() <= 1e-5 * s + 1e-6).all()


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bn_stats_kernels_match_plain(cuda, shape, channel_dim, dtype):
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_grad_stats, bn_grad_stats_reference, bn_stats, bn_stats_reference,
        channel_view)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, dy = _k3_inputs(cuda, shape, dtype, 0)
    a, c, b = channel_view(x.shape, channel_dim)
    x3, dy3 = x.reshape(a, c, b).float(), dy.reshape(a, c, b).float()
    before = dict(launch_counts)
    got = bn_stats(x, channel_dim)
    torch.cuda.synchronize()
    _k3_close(got, bn_stats_reference(x, channel_dim),
              (x3.abs().sum((0, 2)), (x3 * x3).sum((0, 2))))
    mean = got[0] / (a * b)
    rstd = torch.rsqrt((got[1] / (a * b) - mean * mean).clamp(min=0) + 1e-5)
    got = bn_grad_stats(dy, x, mean, rstd, channel_dim)
    torch.cuda.synchronize()
    xhat = (x3 - mean.view(1, c, 1)) * rstd.view(1, c, 1)
    _k3_close(got, bn_grad_stats_reference(dy, x, mean, rstd, channel_dim),
              (dy3.abs().sum((0, 2)), (dy3 * xhat).abs().sum((0, 2))))
    assert launch_counts['bn_stats'] == before.get('bn_stats', 0) + 1
    assert launch_counts['bn_grad_stats'] == before.get('bn_grad_stats', 0) + 1


def test_bn_stats_kernels_refuse_bad_cuda_inputs(cuda):
    from bpbreid_tpu_torch.ops.cuda.batchnorm import bn_grad_stats, bn_stats
    x = torch.zeros(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError):          # not contiguous: no copy made
        bn_stats(x.transpose(2, 3))
    with pytest.raises(TypeError):
        bn_stats(x.half())
    mean = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        bn_grad_stats(x.transpose(2, 3), x, mean, mean)
    with pytest.raises(ValueError):
        bn_grad_stats(x, x, mean[:4], mean)


def test_train_batch_norm_on_the_card_matches_the_cpu(cuda):
    """FastBatchNorm in train mode on the card (both K3 entry points)
    against the same module on the CPU: y, dx, dscale, dbias and the
    running statistics, f32, 1e-4 (sums in another order)."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, dy = _k3_inputs(cuda, (8, 16, 12, 5), torch.float32, 1)
    out = {}
    for dev in (cuda, torch.device('cpu')):
        bn = FastBatchNorm(16).train().to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
            bn.bias.fill_(0.1)
        xi = x.detach().clone().to(dev).requires_grad_(True)
        before = dict(launch_counts)
        bn(xi).backward(dy.to(dev))
        if dev.type == 'cuda':
            torch.cuda.synchronize()
            assert launch_counts['bn_stats'] == before.get('bn_stats', 0) + 1
            assert launch_counts['bn_grad_stats'] == \
                before.get('bn_grad_stats', 0) + 1
        out[dev.type] = [t.detach().cpu() for t in (
            xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)]
    for a, b in zip(out['cuda'], out['cpu']):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# K1: the main path's branch chains (N=64 at 384x128) and ragged shapes
K1_SHAPES = [((64, 96, 32, 32), 4), ((64, 12, 4, 256), 4), ((1, 5, 3, 8), 1),
             ((2, 1, 1, 32), 2), ((2, 2, 1, 32), 3), ((3, 7, 5, 33), 2)]


def _k1_inputs(device, shape, blocks, seed):
    n, h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=gen)
    weights = torch.randn((2 * blocks, 3, 3, c, c), device=device,
                          generator=gen) / (3.0 * c ** 0.5)
    scales = 1.0 + 0.1 * torch.randn((2 * blocks, c), device=device,
                                     generator=gen)
    biases = 0.1 * torch.randn((2 * blocks, c), device=device, generator=gen)
    return x, weights, scales, biases


@pytest.mark.parametrize('shape,blocks', K1_SHAPES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_conv_chain_kernel_matches_plain(cuda, monkeypatch, shape, blocks,
                                         dtype):
    """K1 against its plain version (f32 cuDNN convs, TF32 off): f32 sums
    in another order, 1e-4 of the output's largest magnitude; a bf16
    output within 2 bf16 ulps of the plain one plus that f32 term (values
    near a ReLU's zero or a rounding boundary move by the f32 noise)."""
    from bpbreid_tpu_torch.ops.conv_chain import (basicblock_chain_reference,
                                                  fused_basicblock_chain)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    x, w, s, b = _k1_inputs(cuda, shape, blocks, 0)
    x = x.to(dtype)
    before = launch_counts['conv_chain']
    got = fused_basicblock_chain(x, w, s, b)
    torch.cuda.synchronize()
    assert launch_counts['conv_chain'] == before + blocks
    want = basicblock_chain_reference(x, w, s, b)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    f32_tol = 1e-4 * want.float().abs().max().item() + 1e-6
    if dtype == torch.float32:
        assert err.max().item() <= f32_tol
    else:
        assert (err <= 2 * 2.0 ** -7 * want.float().abs() + f32_tol).all()


def test_counting_ranker_on_the_card_matches_the_cpu(cuda):
    """``cmc_map_counting`` and ``cmc_map`` on the card against the same
    functions on the CPU: tied distances included, CMC and mAP 1e-6,
    counts equal."""
    import numpy as np
    from bpbreid_tpu_torch.ops.ranking import cmc_map, cmc_map_counting
    rng = np.random.default_rng(0)
    d = np.round(rng.random((173, 5000)) * 64).astype(np.float32) / 64
    ids = [rng.integers(0, 60, 173), rng.integers(0, 120, 5000),
           rng.integers(0, 6, 173), rng.integers(0, 6, 5000)]
    for fn in (cmc_map_counting, cmc_map):
        outs = [fn(torch.from_numpy(d).to(dev),
                   *(torch.from_numpy(i).to(dev) for i in ids), max_rank=50)
                for dev in (cuda, torch.device('cpu'))]
        for a, b in zip(*outs):
            assert a.device.type == 'cuda'
            if b.dtype == torch.int32:
                assert int(a) == int(b)
            else:
                torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)
