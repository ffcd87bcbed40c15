"""bpbreid_tpu_torch kernels on the card (marker ``cuda``; skipped
without a CUDA device). Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

The attention-pool kernel (K2) is held against its plain version on the
same CUDA inputs: f32 sums over the pixels in another order, so the
tolerance is 2e-5 of the largest output magnitude. The BN-sum kernels
(K3, forward and backward) sum in f64 and the plain version in f32: 1e-5
of the per-channel sum of magnitudes; bn_stats's epilogue on its own
sums 1e-6 relative. The BN elementwise passes (bn_apply, bn_dx) round as
their plain versions do: one ulp of the output type plus 1e-6 of the
terms' magnitude. Only the K3 and BN tests: ``-k bn``."""
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


# K3 and the BN elementwise passes: [A, C, B] views of the main path's
# shapes (NCHW and [M, C]) and ragged ones (odd C, C = 3, B = 7, odd H*W,
# A = 1, B = 1)
K3_SHAPES = [((64, 32, 96, 32), 1), ((64, 256, 12, 4), 1), ((64, 512), -1),
             ((320, 512), -1), ((3, 7, 5, 3), 1), ((1, 33, 9, 7), 1),
             ((2, 3, 7, 1), 1), ((1, 5), -1), ((5, 3, 6), -1)]
# the global-embedding models' BN inputs at 256x128, batch 64: OSNet's
# stem, its stages' mid and output widths and fc.1; ResNet-IBN's IBN-a
# half of layer1 and its layer4 output
K3_SHAPES += [((64, 64, 128, 64), 1), ((64, 64, 64, 32), 1),
              ((64, 96, 32, 16), 1), ((64, 128, 16, 8), 1),
              ((64, 512, 16, 8), 1), ((64, 32, 64, 32), 1),
              ((64, 2048, 8, 4), 1)]


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


def _ew_close(got, want, terms):
    """bn_apply and bn_dx against their plain versions on the same
    constants: one ulp of the output type, plus 1e-6 of the magnitude of
    the terms summed (``terms``, f32)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    assert (err <= ulp * want.float().abs() + 1e-6 * terms + 1e-30).all()


def _stats(cuda, x, channel_dim, seed=3):
    from bpbreid_tpu_torch.ops.cuda.batchnorm import bn_stats, channel_view
    c = channel_view(x.shape, channel_dim)[1]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    weight = 1 + 0.2 * torch.randn(c, device=cuda, generator=gen)
    bias = 0.3 * torch.randn(c, device=cuda, generator=gen)
    return weight, bias, bn_stats(x, weight, 1e-5, channel_dim, sums=True)


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bn_stats_kernels_match_plain(cuda, shape, channel_dim, dtype):
    """bn_stats (sums, epilogue, running update) and bn_grad_stats."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_finalize_reference, bn_grad_stats, bn_grad_stats_reference,
        bn_stats, bn_stats_reference, channel_view)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, dy = _k3_inputs(cuda, shape, dtype, 0)
    a, c, b = channel_view(x.shape, channel_dim)
    x3, dy3 = x.reshape(a, c, b).float(), dy.reshape(a, c, b).float()
    before = dict(launch_counts)
    weight, _, got = _stats(cuda, x, channel_dim)
    torch.cuda.synchronize()
    _k3_close(got[4:], bn_stats_reference(x, weight, 1e-5, channel_dim,
                                          sums=True)[4:],
              (x3.abs().sum((0, 2)), (x3 * x3).sum((0, 2))))
    # the epilogue on the kernel's own sums, and the running update
    rm = torch.linspace(-1, 1, c, device=cuda)
    rv = torch.linspace(0.5, 2, c, device=cuda)
    rm_k, rv_k = rm.clone(), rv.clone()
    got = bn_stats(x, weight, 1e-5, channel_dim, rm_k, rv_k, sums=True)
    want = bn_finalize_reference(got[4], got[5], a * b, weight, 1e-5, rm, rv)
    for g, w in zip(got[:4] + (rm_k, rv_k), want + (rm, rv)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    mean, rstd = got[0], got[2]
    got = bn_grad_stats(dy, x, mean, rstd, channel_dim)
    torch.cuda.synchronize()
    xhat = (x3 - mean.view(1, c, 1)) * rstd.view(1, c, 1)
    _k3_close(got, bn_grad_stats_reference(dy, x, mean, rstd, channel_dim),
              (dy3.abs().sum((0, 2)), (dy3 * xhat).abs().sum((0, 2))))
    assert launch_counts['bn_stats'] == before.get('bn_stats', 0) + 2
    assert launch_counts['bn_grad_stats'] == before.get('bn_grad_stats', 0) + 1


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('other', [torch.float32, torch.bfloat16])
def test_bn_apply_and_dx_kernels_match_plain(cuda, shape, channel_dim,
                                             dtype, other):
    """bn_apply (x of ``dtype``, y of ``other``, with and without bias)
    and bn_dx (x of ``dtype``, dy of ``other``) on the same constants."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_apply, bn_apply_reference, bn_dx, bn_dx_reference, bn_grad_stats,
        channel_view)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, dy = _k3_inputs(cuda, shape, dtype, 1)
    dy = dy.to(other)
    a, c, b = channel_view(x.shape, channel_dim)
    weight, bias, (mean, _, rstd, scale, _, _) = _stats(cuda, x, channel_dim)
    x3 = x.reshape(a, c, b).float()
    before = dict(launch_counts)
    for bi in (bias, None):
        got = bn_apply(x, mean, rstd, weight, bi, channel_dim, other)
        want = bn_apply_reference(x, mean, rstd, weight, bi, channel_dim,
                                  other)
        terms = ((x3 - mean.view(1, c, 1)).abs()
                 * scale.abs().view(1, c, 1)).view(x.shape)
        if bi is not None:
            terms = terms + bi.abs().view(1, c, 1).expand(a, c, b) \
                .reshape(x.shape)
        _ew_close(got, want, terms)
    sum_dy, sum_dy_xhat = bn_grad_stats(dy, x, mean, rstd, channel_dim)
    got = bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat, channel_dim)
    want = bn_dx_reference(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat,
                           channel_dim)
    xhat = (x3 - mean.view(1, c, 1)) * rstd.view(1, c, 1)
    terms = scale.abs().view(1, c, 1) * (
        dy.reshape(a, c, b).float().abs() + (sum_dy.abs() / (a * b)).view(
            1, c, 1) + (xhat * sum_dy_xhat.view(1, c, 1) / (a * b)).abs())
    _ew_close(got, want, terms.view(x.shape))
    assert got.dtype == x.dtype
    assert launch_counts['bn_apply'] == before.get('bn_apply', 0) + 2
    assert launch_counts['bn_dx'] == before.get('bn_dx', 0) + 1


def test_bn_kernels_are_bit_identical_across_calls(cuda):
    """The cluster reduction sums in a fixed order: two calls give the
    same bits, at the step's largest input and at a [M, C] feature."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import bn_dx, bn_grad_stats
    for shape, cd in (((64, 64, 192, 64), 1), ((320, 512), -1)):
        x, dy = _k3_inputs(cuda, shape, torch.bfloat16, 2)
        runs = []
        for _ in range(2):
            _, _, st = _stats(cuda, x, cd)
            g = bn_grad_stats(dy, x, st[0], st[2], cd)
            runs.append(st + g + (bn_dx(dy, x, st[0], st[2], st[3], *g,
                                        channel_dim=cd),))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_bn_stats_kernels_refuse_bad_cuda_inputs(cuda):
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_apply, bn_dx,
                                                      bn_grad_stats, bn_stats)
    x = torch.zeros(2, 8, 4, 4, device=cuda)
    w = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):          # not contiguous: no copy made
        bn_stats(x.transpose(2, 3), w, 1e-5)
    with pytest.raises(TypeError):
        bn_stats(x.half(), w, 1e-5)
    with pytest.raises(ValueError):
        bn_stats(x, w[:4], 1e-5)
    with pytest.raises(ValueError):          # one running buffer alone
        bn_stats(x, w, 1e-5, running_mean=w.clone())
    with pytest.raises(ValueError):
        bn_grad_stats(x.transpose(2, 3), x, w, w)
    with pytest.raises(ValueError):
        bn_grad_stats(x, x, w[:4], w)
    with pytest.raises(ValueError):
        bn_apply(x, w, w, w.double())
    with pytest.raises(TypeError):
        bn_apply(x, w, w, w, dtype=torch.float16)
    with pytest.raises(ValueError):
        bn_dx(x, x[:1], w, w, w, w, w)


def test_train_batch_norm_on_the_card_matches_the_cpu(cuda):
    """FastBatchNorm in train mode on the card (2 launches forward:
    bn_stats, bn_apply; 2 backward: bn_grad_stats, bn_dx) against the same
    module on the CPU: y, dx, dscale, dbias and the running statistics,
    f32, 1e-4 (sums in another order)."""
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
        y = bn(xi)
        y.backward(dy.to(dev))
        if dev.type == 'cuda':
            torch.cuda.synchronize()
            for name in ('bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx'):
                assert launch_counts[name] == before.get(name, 0) + 1, name
            assert sum(launch_counts.values()) == sum(before.values()) + 4
        out[dev.type] = [t.detach().cpu() for t in (
            y, xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)]
    for a, b in zip(out['cuda'], out['cpu']):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('shape,channel_dim,dtype', [
    ((4, 16, 12, 8), 1, torch.bfloat16), ((6, 5, 32), -1, torch.float32)])
def test_eval_batch_norm_on_the_card_is_one_launch(cuda, shape, channel_dim,
                                                   dtype):
    """FastBatchNorm in eval mode: one bn_apply launch, and the CPU's
    output (f32 1e-5; bf16 one ulp)."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, _ = _k3_inputs(cuda, shape, torch.float32, 4)
    c = shape[channel_dim]
    out = {}
    for dev in (cuda, torch.device('cpu')):
        bn = FastBatchNorm(c, channel_dim=channel_dim, dtype=dtype).eval() \
            .to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.fill_(0.1)
            bn.running_mean.copy_(torch.linspace(-0.5, 0.5, c))
            bn.running_var.copy_(torch.linspace(0.5, 2.0, c))
        before = dict(launch_counts)
        with torch.inference_mode():
            out[dev.type] = bn(x.to(dev)).float().cpu()
        if dev.type == 'cuda':
            assert launch_counts['bn_apply'] == before.get('bn_apply', 0) + 1
            assert sum(launch_counts.values()) == sum(before.values()) + 1
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out['cuda'], out['cpu'], atol=1e-5, rtol=tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ibn_layer_on_the_card_matches_the_cpu(cuda, dtype):
    """IBN-a's half instance norm, half batch norm in train mode: the BN
    half is copied once (counted), goes through the four BN kernels, and
    the output, the input gradient and the running statistics equal the
    CPU's (f32 1e-4; bf16 2 ulps of the output, 1e-2 of the gradient)."""
    from bpbreid_tpu_torch.models.common import init_parameters
    from bpbreid_tpu_torch.models.resnet_fastreid import IBNLayer
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, dy = _k3_inputs(cuda, (8, 64, 16, 8), dtype, 5)
    out = {}
    for dev in (cuda, torch.device('cpu')):
        layer = IBNLayer(64, dtype=dtype)
        init_parameters(layer, torch.Generator().manual_seed(0))
        layer.train().to(dev)
        xi = x.detach().clone().to(dev).requires_grad_(True)
        before = dict(launch_counts)
        y = layer(xi)
        y.backward(dy.to(dev))
        if dev.type == 'cuda':
            torch.cuda.synchronize()
            for name in ('bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx'):
                assert launch_counts[name] == before.get(name, 0) + 1, name
        assert layer.copies == 1
        out[dev.type] = [t.detach().float().cpu() for t in (
            y, xi.grad, layer.BN.running_mean, layer.BN.running_var)]
    f32 = dtype == torch.float32
    for a, b, tol in zip(out['cuda'], out['cpu'], (
            1e-4 if f32 else 2 ** -6, 1e-4 if f32 else 1e-2, 1e-4, 1e-4)):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize('name', ['osnet_x0_25', 'resnet50_ibn_a'])
def test_global_model_train_step_launches_the_bn_kernels(cuda, name):
    """A zoo model's train-mode forward and backward on the card: two BN
    kernels forward and two backward for each ``FastBatchNorm`` call, the
    class scores finite; eval mode one ``bn_apply`` a call."""
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    model = build_model(name, 10, loss='softmax', dtype=torch.bfloat16)
    calls = []
    for m in model.modules():
        if isinstance(m, FastBatchNorm):
            m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
    x = torch.randn(8, 3, 128, 64, device=cuda)
    before = dict(launch_counts)
    model.train()
    scores = model(x)
    scores.float().sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(scores.float()).all()
    n = len(calls)
    assert n > 0
    for kernel in ('bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx'):
        assert launch_counts[kernel] - before.get(kernel, 0) == n, kernel
    calls.clear()
    before = dict(launch_counts)
    with torch.inference_mode():
        model.eval()(x)
    assert launch_counts['bn_apply'] - before.get('bn_apply', 0) \
        == len(calls) == n
    assert launch_counts['bn_stats'] == before.get('bn_stats', 0)


# K1: the main path's branch chains (N=64 at 384x128) and ragged shapes
K1_SHAPES = [((64, 96, 32, 32), 4), ((64, 48, 16, 64), 4),
             ((64, 24, 8, 128), 4), ((64, 12, 4, 256), 4), ((1, 5, 3, 8), 1),
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
    """K1 against its plain version of the input's type (f32 cuDNN convs,
    TF32 off). f32: sums in another order, 1e-4 of the output's largest
    magnitude; one launch per block. bf16 (two launches per block): against
    ``basicblock_chain_bf16_reference``, within 2 bf16 ulps of each value
    plus 3e-3 of the largest (f32 sums in another order move some y1 and
    block-input values across a bf16 rounding boundary, and the later
    blocks carry that ulp: 1.1-1.5e-3 of the largest at the main shapes,
    none at the ragged ones, on an H100); against the f32 contract
    ``basicblock_chain_reference``, rel. L2 1e-2 (bf16 operands; 3-4e-3
    measured)."""
    from bpbreid_tpu_torch.ops.conv_chain import (
        basicblock_chain_bf16_reference, basicblock_chain_reference,
        fused_basicblock_chain)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    x, w, s, b = _k1_inputs(cuda, shape, blocks, 0)
    x = x.to(dtype)
    x_before = x.clone()
    before = launch_counts['conv_chain']
    got = fused_basicblock_chain(x, w, s, b)
    torch.cuda.synchronize()
    assert torch.equal(x, x_before)
    want_f32 = basicblock_chain_reference(x, w, s, b)
    assert got.dtype == dtype and got.shape == want_f32.shape
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert launch_counts['conv_chain'] == before + blocks
        err = (got - want_f32).abs().max().item()
        assert err <= 1e-4 * want_f32.abs().max().item() + 1e-6
        return
    assert launch_counts['conv_chain'] == before + 2 * blocks
    want = basicblock_chain_bf16_reference(x, w, s, b).float()
    err = (got.float() - want).abs()
    tol = 2 * 2.0 ** -7 * want.abs() + 3e-3 * want.abs().max().item() + 1e-6
    assert (err <= tol).all(), err.max().item()
    want_f32 = want_f32.float()
    rel_l2 = ((got.float() - want_f32).norm() / want_f32.norm()).item()
    assert rel_l2 <= 1e-2, rel_l2


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


def test_device_prefetch_keeps_the_stream_order(cuda):
    """Batches copied on the side stream arrive whole while the compute
    stream is busy: each equals its host batch bit for bit, the host-side
    fields stay numpy, and tensors freed while a later step still runs
    are not overwritten (``record_stream``)."""
    import numpy as np
    from bpbreid_tpu_torch.engine.engine import device_prefetch
    rng = np.random.default_rng(0)
    host = [{'image': rng.integers(0, 256, (64, 384, 128, 3), dtype=np.uint8),
             'mask': rng.random((64, 48, 16, 36), dtype=np.float32),
             'pid': rng.integers(0, 751, 64).astype(np.int32),
             'camid': np.full(64, i, np.int32)} for i in range(6)]
    busy = torch.randn(4096, 4096, device=cuda)
    sums = []
    for i, batch in enumerate(device_prefetch(host, cuda)):
        for _ in range(4):                 # keep the compute stream busy
            busy = busy @ busy / 4096
        assert batch['image'].device.type == 'cuda'
        assert isinstance(batch['camid'], np.ndarray)
        sums.append((batch['image'].sum(dtype=torch.int64),
                     batch['mask'].double().sum(), batch['pid'].clone()))
        del batch
    torch.cuda.synchronize()
    for (img, mask, pid), want in zip(sums, host):
        assert img.item() == int(want['image'].sum(dtype=np.int64))
        assert mask.item() == pytest.approx(float(want['mask'].astype(
            np.float64).sum()), rel=1e-12)
        assert pid.cpu().numpy().tolist() == want['pid'].tolist()
    first = next(iter(device_prefetch(host[:1], cuda)))
    for k in ('image', 'mask', 'pid'):
        assert torch.equal(first[k].cpu(), torch.as_tensor(host[0][k]))


def test_cli_launches_the_bn_kernels(cuda, tmp_path):
    """The CLI on the smoke config (resnet18, 4 train steps, 18 eval
    batches): two forward BN kernels for every train-mode BN call, two
    backward ones for each that gets a gradient, one ``bn_apply`` for
    every eval-mode BN call, counted against forward hooks."""
    import os
    import types
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.scripts import main as cli
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clear_dataset_cache()
    cfg = cli.build_config(
        types.SimpleNamespace(save_dir=str(tmp_path), job_id=1, opts=[]),
        os.path.join(repo, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml'))
    engine, model = cli.build_model_engine(cfg)
    calls = {'train': 0, 'eval': 0}

    def hook(mod, inp):
        calls['train' if mod.training else 'eval'] += 1
    for m in model.modules():
        if isinstance(m, FastBatchNorm):
            m.register_forward_pre_hook(hook)
    reset_launch_counts()
    engine.run(max_epoch=1, test_only=False, save_dir=cfg.data.save_dir)
    torch.cuda.synchronize()
    assert calls['train'] > 0 and calls['eval'] > 0
    assert launch_counts['bn_stats'] == calls['train']
    assert launch_counts['bn_apply'] == calls['train'] + calls['eval']
    assert launch_counts['bn_grad_stats'] == launch_counts['bn_dx']
    assert 0 < launch_counts['bn_grad_stats'] <= calls['train']


def _serving_config(dtype='float32'):
    """BPBReID on resnet18 at 64x32, five_v, the serving configuration
    (fused pooling through K2, multires off)."""
    from bpbreid_tpu_torch.config import get_default_config
    cfg = get_default_config()
    cfg.data.height, cfg.data.width = 64, 32
    cfg.model.bpbreid.backbone = 'resnet18'
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.model.bpbreid.masks.parts_num = 5
    cfg.model.bpbreid.use_pallas_pooling = True
    cfg.model.bpbreid.multires_pooling = False
    cfg.model.compute_dtype = dtype
    return cfg


def test_feature_extractor_on_the_card_matches_the_cpu(cuda):
    """The same seeded model on the card and on the CPU, f32 with TF32
    off, on arrays of mixed sizes: embeddings to 1e-3, visibility equal;
    on the card one bn_apply per eval-mode BN call (forward hooks) and
    one K2 launch a batch, and no other kernel of the port."""
    import numpy as np
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.tools import FeatureExtractor
    cfg = _serving_config()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((80, 40), (50, 30), (64, 32), (121, 45))]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = FeatureExtractor(cfg, device='cpu', num_classes=7)(images)
        card = FeatureExtractor(cfg, device=cuda, num_classes=7)
        calls = []
        for m in card.model.modules():
            if isinstance(m, FastBatchNorm):
                m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
        torch.cuda.synchronize()
        reset_launch_counts()
        got = card(images)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts.items() if v}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert calls and counts == {'bn_apply': len(calls), 'attention_pool': 1}
    for k, v in want[0].items():
        assert (got[0][k].cpu() - v).abs().max().item() <= 1e-3, k
    for k, v in want[1].items():
        assert torch.equal(got[1][k].cpu(), v), k


def test_torchreid_weights_load_into_a_cuda_model(cuda, tmp_path):
    """A torchreid file (``module.`` prefixes, ``num_batches_tracked``,
    a ``state_dict`` wrapper) read on the CPU and copied into a model on
    the card, f32 and bf16: every tensor equal to the file's."""
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.utils.torch_weights import (
        load_torch_state_dict, load_torchreid_state_dict)
    cfg = _serving_config()
    src = build_model('bpbreid', 9, config=cfg, device='cpu', seed=3)
    sd = {'module.' + k: v for k, v in src.state_dict().items()}
    sd.update({'module.' + k[:-len('running_mean')] + 'num_batches_tracked':
               torch.tensor(5) for k in src.state_dict()
               if k.endswith('running_mean')})
    path = str(tmp_path / 'model.pth.tar')
    torch.save({'state_dict': sd, 'epoch': 1}, path)
    for dtype in ('float32', 'bfloat16'):
        dst = build_model('bpbreid', 9, config=_serving_config(dtype),
                          device=cuda, seed=4)
        matched, discarded = load_torchreid_state_dict(
            dst, load_torch_state_dict(path)[0])
        assert not discarded and len(matched) == len(src.state_dict())
        for k, v in dst.state_dict().items():
            assert v.device.type == 'cuda', k
            assert torch.equal(v.cpu(), src.state_dict()[k].to(v.dtype)), k


@pytest.mark.parametrize('optim', ['amsgrad', 'rmsprop', 'radam'])
def test_optimizer_rules_on_the_card_match_the_cpu(cuda, optim):
    """Eight steps of ``OptaxRule`` (weight decay, staged lr; radam
    crosses its threshold) on the card and on the CPU from the same
    parameters and gradients: the parameters within 1e-6 of the size of
    the run's updates, plus one float32 ulp of the parameter per step
    (the final ``p - lr u`` may round once otherwise where the card
    fuses the multiply-add), and no launch of the port's kernels."""
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.optim import build_optimizer
    gen = torch.Generator().manual_seed(5)
    shapes = {'backbone.w': (64, 33), 'backbone.b': (33,),
              'classifier.w': (33, 7)}
    init = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) / (1 + t)
              for k, s in shapes.items()} for t in range(8)]
    lr = 1e-3
    out = []
    reset_launch_counts()
    for device in ('cpu', cuda):
        model = torch.nn.Module()
        for group in ('backbone', 'classifier'):
            setattr(model, group, torch.nn.ParameterDict(
                {k.split('.')[1]: torch.nn.Parameter(v.clone().to(device))
                 for k, v in init.items() if k.startswith(group)}))
        opt = build_optimizer(model, optim=optim, lr=lr, weight_decay=5e-4,
                              staged_lr=True, new_layers=['classifier'])
        for g in grads:
            for name, p in model.named_parameters():
                p.grad = g[name].to(device)
            opt.step()
        out.append({n: p.detach().cpu() for n, p in model.named_parameters()})
    assert not any(launch_counts.values())
    eps = torch.finfo(torch.float32).eps
    for name in shapes:
        moved = (out[0][name] - init[name]).abs().max().item()
        tol = 1e-6 * moved + len(grads) * eps * out[0][name].abs()
        assert ((out[0][name] - out[1][name]).abs() <= tol).all(), name


def test_dropout_dim_reduce_on_the_card_matches_the_cpu(cuda):
    """The ``after_pooling_with_dropout`` reduction on the card: a
    generator seed gives the same mask twice, about half of 512
    dimensions kept, kept entries twice the undropped ones; eval mode
    equal to the CPU's (f32, TF32 off) and to the model without dropout,
    bit for bit."""
    from bpbreid_tpu_torch.models.bpbreid import (AfterPoolingDimReduce,
                                                  set_dropout_generator)
    from bpbreid_tpu_torch.models.common import init_parameters
    plain = AfterPoolingDimReduce(96, 512)
    init_parameters(plain, torch.Generator().manual_seed(0))
    drop = AfterPoolingDimReduce(96, 512, dropout_rate=0.5)
    drop.load_state_dict(plain.state_dict())
    plain, drop = plain.to(cuda), drop.to(cuda)
    x = torch.randn(64, 96, generator=torch.Generator().manual_seed(1))
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            # eval mode first: the train-mode calls below move the BN
            # running statistics
            got = drop.eval()(x.to(cuda))
            assert torch.equal(got, plain.eval()(x.to(cuda)))
            cpu = AfterPoolingDimReduce(96, 512, dropout_rate=0.5)
            cpu.load_state_dict(drop.state_dict())
            assert (got.cpu() - cpu.eval()(x)).abs().max().item() <= 1e-5
            masks = []
            for _ in range(2):
                set_dropout_generator(
                    drop, torch.Generator(cuda).manual_seed(3))
                masks.append(drop.train()(x.to(cuda)))
            want = plain.train()(x.to(cuda))
            kept = masks[0] != 0
            assert torch.equal(masks[0], masks[1])
            assert torch.equal(masks[0][kept], 2 * want[kept])
            positive = want > 0
            share = (kept & positive).sum().item() / positive.sum().item()
            assert abs(share - 0.5) <= 0.02
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_ranking_grid_from_card_tensors(cuda, tmp_path):
    """The smoke config's test with ``test.visrank`` on the card (the
    attention maps of the grids from ``eval_step`` on card tensors):
    every grid decodes with ``(topk+1) x (P+1)`` cells and their
    titles."""
    import os
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.data.datasets.dataset import (read_image,
                                                         read_png_text)
    from bpbreid_tpu_torch.scripts import main as cli
    from bpbreid_tpu_torch.utils.visualization import rankings
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clear_dataset_cache()
    engine, _ = cli.main([
        '--config-file',
        os.path.join(repo, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml'),
        '--save_dir', str(tmp_path), '--job-id', '1', 'test.evaluate',
        'True', 'test.visrank', 'True', 'test.visrank_topk', '4',
        'test.visrank_count', '2', 'test.visrank_q_idx_list', '[0]'])
    out_dir = tmp_path / '1' / 'visrank_synthetic'
    files = sorted(os.listdir(out_dir))
    assert len(files) == 2
    streams = 1 + engine.model.parts_num
    cell = (rankings.THUMB_HW[0] + 2 * rankings.BORDER,
            rankings.THUMB_HW[1] + 2 * rankings.BORDER)
    gap = rankings.GRID_SPACING
    for f in files:
        img = read_image(str(out_dir / f))
        assert img.shape == (5 * cell[0] + 4 * gap,
                             (streams + 1) * cell[1] + streams * gap, 3)
        text = read_png_text(str(out_dir / f))
        assert text['r0c0'].startswith('query pid')
        assert len([k for k in text if k.startswith('r')]) == \
            5 * (streams + 1)


# int8 eval (conv_s8.cu): (N, Cin, H, W, Co, kernel, stride), main-path
# branch convs and ragged ones (Cin 3 and 40, Co 5, odd H and W, stride 2);
# the four HRNet-W32 branch 3x3s of the int8 serving step at its batch;
# its strided fuse and transition convs and layer1's 1x1s at batch 16;
# halo edge cases: N = 1, Ho and Wo not multiples of the tile, odd H and
# W at stride 2, Cp 32 to 1024, Co not a multiple of the tile's channels
S8_CONV_SHAPES = [(64, 32, 96, 32, 32, 3, 1), (8, 256, 24, 8, 64, 1, 1),
                  (2, 3, 17, 9, 64, 3, 2), (3, 40, 7, 5, 5, 3, 1),
                  (2, 64, 13, 11, 130, 1, 2), (1, 96, 6, 4, 72, 3, 2),
                  (64, 64, 48, 16, 64, 3, 1), (64, 128, 24, 8, 128, 3, 1),
                  (64, 256, 12, 4, 256, 3, 1),
                  (16, 32, 96, 32, 64, 3, 2), (16, 32, 96, 32, 32, 3, 2),
                  (16, 32, 48, 16, 128, 3, 2), (16, 64, 48, 16, 128, 3, 2),
                  (16, 128, 24, 8, 256, 3, 2), (16, 256, 96, 32, 32, 3, 1),
                  (16, 256, 96, 32, 64, 3, 2), (16, 64, 96, 32, 256, 1, 1),
                  (16, 256, 96, 32, 64, 1, 1), (16, 256, 12, 4, 1024, 1, 1),
                  (1, 32, 97, 33, 33, 3, 1), (2, 64, 25, 9, 96, 3, 2),
                  (1, 1024, 13, 5, 200, 1, 1), (2, 512, 25, 9, 96, 3, 2),
                  (1, 160, 3, 130, 40, 3, 1)]


def _s8_conv_inputs(cuda, shape, seed):
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (pack_weight_s8,
                                                    padded_channels)
    n, cin, h, w, co, k, _ = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cp = padded_channels(cin)
    xq = torch.zeros(n, h, w, cp, dtype=torch.int8, device=cuda)
    xq[..., :cin] = torch.randint(-127, 128, (n, h, w, cin), device=cuda,
                                  generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (co, cin, k, k), device=cuda,
                       generator=gen).to(torch.int8)
    sw = torch.rand(co, device=cuda, generator=gen) * 1e-3
    bias = torch.randn(co, device=cuda, generator=gen)
    return xq, pack_weight_s8(wq, cp), sw, bias


@pytest.mark.parametrize('shape', S8_CONV_SHAPES)
@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_conv_s8_kernel_matches_plain(cuda, shape, out_dtype):
    """The int32 sums are exact and the epilogue rounds as the plain
    version: bit-equal, with and without a bias."""
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import conv_s8, conv_s8_reference
    xq, w, sw, bias = _s8_conv_inputs(cuda, shape, 0)
    k, stride, cin = shape[5], shape[6], shape[1]
    for b in (None, bias):
        before = launch_counts['conv_s8']
        got = conv_s8(xq, w, sw, b, k, stride, k // 2, cin,
                      out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert launch_counts['conv_s8'] == before + 1
        want = conv_s8_reference(xq, w, sw, b, k, stride, k // 2, cin,
                                 out_dtype=out_dtype)
        assert got.shape == want.shape and got.dtype == out_dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize('shape', [(64, 32, 96, 32), (3, 5, 7, 9),
                                   (2, 70, 13, 1), (64, 256, 96, 32),
                                   (2, 100, 11, 13), (3, 96, 9, 16),
                                   (2, 36, 8, 8), (1, 1920, 3, 8)])
@pytest.mark.parametrize('per_channel', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_quantize_s8_kernel_matches_plain(cuda, shape, per_channel, dtype):
    """A true division and round-half-even: bit-equal, from NCHW and from
    channels-last memory; the pad channels are 0."""
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (quantize_s8,
                                                    quantize_s8_reference)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (3 * torch.randn(*shape, device=cuda, generator=gen)).to(dtype)
    # values on the rounding ties of the scale, zeros and negative zeros
    x.view(-1)[:64] = (torch.arange(64, device=cuda) - 32.5).to(dtype) * 0.5
    x.view(-1)[64:80] = 0.0
    x.view(-1)[80:96] = -0.0
    c = shape[1]
    scale = (torch.rand(c if per_channel else 1, device=cuda,
                        generator=gen) * 0.05 + 0.01)
    if not per_channel:
        scale = scale.reshape(())
    want = quantize_s8_reference(x, scale)
    for xin in (x, x.contiguous(memory_format=torch.channels_last)):
        got = quantize_s8(xin, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert not want[..., c:].any()


@pytest.mark.parametrize('shape', [(4, 32, 24, 16, 32, 3, 1),
                                   (3, 64, 13, 16, 96, 3, 2),
                                   (2, 128, 12, 8, 64, 1, 1)])
def test_conv_s8_other_tile_plans_are_bit_equal(cuda, shape):
    """Plans other than the planner's (``conv_s8(..., plan=)``, as
    int8_bench.py --box-rows times them): box rows grouped or one pixel's
    channels, other chunks, stages, tiles and channel blocks; each laid out
    by ``conv_layout`` and bit-equal to the plain version."""
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (
        check_conv_plan, conv_s8, conv_s8_reference, plan_conv_tiles)
    xq, w, sw, bias = _s8_conv_inputs(cuda, shape, 4)
    n, cin, h, wd, co, k, stride = shape
    cp = xq.shape[-1]
    want = conv_s8_reference(xq, w, sw, bias, k, stride, k // 2, cin)
    base = plan_conv_tiles(n, h, wd, cp, co, k, stride, k // 2)
    plans = {base, base._replace(grouped=not base.grouped),
             base._replace(stages=5 - base.stages),
             base._replace(th=base.th * base.tw // 8, tw=8),
             base._replace(bn=96 - base.bn)}
    plans |= {base._replace(kc=kc, grouped=False) for kc in (32, 64, 128)
              if cp % kc == 0}
    tried = 0
    for plan in plans:
        try:
            check_conv_plan(plan, k, stride, k // 2, cp, wd)
        except ValueError:
            continue
        got = conv_s8(xq, w, sw, bias, k, stride, k // 2, cin, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan
        tried += 1
    assert tried >= 4


def test_conv_s8_entry_point_checks_the_layout_it_is_given(cuda):
    """The C entry point takes ``conv_layout``'s layout as given and
    refuses one whose regions cannot hold what the kernel stores there
    (cudaErrorInvalidValue), launching nothing."""
    from bpbreid_tpu_torch.ops.cuda.build import load_kernel
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import conv_layout, plan_conv_tiles
    shape = (2, 32, 16, 16, 32, 3, 1)
    xq, w, sw, _ = _s8_conv_inputs(cuda, shape, 5)
    n, cin, h, wd, co, k, stride = shape
    plan = plan_conv_tiles(n, h, wd, 32, co, k, stride, 1)
    good = conv_layout(plan, k, stride, 1, 32)
    y = torch.zeros(n, co, h, wd, dtype=torch.bfloat16, device=cuda)
    _, fn = load_kernel('conv_s8')

    def launch(layout):
        code = fn(xq.data_ptr(), w.data_ptr(), sw.data_ptr(), None,
                  y.data_ptr(), n, h, wd, 32, co, h, wd, k, stride, 1, 1,
                  *plan[:5], int(plan.grouped), *layout,
                  torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return code
    assert launch(good) == 0 and y.abs().sum() > 0
    y.zero_()
    for bad in (good._replace(smem=good.bar_offset),
                good._replace(tile_offset=good.b_offset),
                good._replace(box_rows=good.box_rows - 1),
                good._replace(halo_bytes=good.halo_bytes - 1024),
                good._replace(b_ld=good.b_ld - 32),
                good._replace(smem=232448 + 1024)):
        assert launch(bad) == 1         # cudaErrorInvalidValue
    assert not y.any()


def test_conv_s8_refuses_groups_and_bad_inputs_on_the_card(cuda):
    """Grouped convs (ResNeXt's Bottleneck.conv2) now run on the card as
    one dense launch over block-diagonal weights, bit-equal to the plain
    grouped version, from the grouped packing and from the expanded one
    (what the int8 weight cache keeps); bad inputs are still refused."""
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (
        conv_s8, conv_s8_reference, expand_grouped_weight_s8, pack_weight_s8)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n, cin, hw, co, k, stride, groups in ((2, 64, 9, 64, 3, 1, 2),
                                              (2, 128, 12, 128, 3, 2, 32),
                                              (3, 96, 7, 48, 1, 1, 4)):
        cp = -(-cin // 32) * 32
        xq = torch.zeros(n, hw, hw, cp, dtype=torch.int8, device=cuda)
        xq[..., :cin] = torch.randint(-127, 128, (n, hw, hw, cin),
                                      device=cuda, generator=gen)
        wq = torch.randint(-127, 128, (co, cin // groups, k, k), device=cuda,
                           generator=gen).to(torch.int8)
        w = pack_weight_s8(wq, cp, groups)
        sw = torch.rand(co, device=cuda, generator=gen) * 1e-3
        want = conv_s8_reference(xq.cpu(), w.cpu(), sw.cpu(), None, k,
                                 stride, k // 2, cin, groups)
        dense = expand_grouped_weight_s8(w, k, cp, cin, groups)
        for wk in (w, dense):
            before = launch_counts['conv_s8']
            got = conv_s8(xq, wk, sw, None, k, stride, k // 2, cin, groups)
            torch.cuda.synchronize()
            assert launch_counts['conv_s8'] == before + 1
            assert torch.equal(got.cpu(), want)
    xq, w, sw, _ = _s8_conv_inputs(cuda, (2, 64, 8, 8, 64, 1, 1), 2)
    with pytest.raises(ValueError):
        conv_s8(xq, w, sw, None, 1, 1, 0, 64, groups=3)
    with pytest.raises(ValueError):
        conv_s8(xq[..., :48].contiguous(), w, sw, None, 1, 1, 0, 48)
    with pytest.raises(ValueError):
        conv_s8(xq, w, sw.double(), None, 1, 1, 0, 64)


def test_int8_model_on_the_card_matches_the_cpu(cuda):
    """A small f32 BPBReID (HRNet-W32 widths, depth cut) in int8 on the
    card and on the CPU (plain versions), every batch norm normalizing
    exactly (mean 0, bias 0, var + eps = 1: the two devices' rsqrt and
    rounding orders then agree): the card's own calibration within 1e-5
    of each range's largest value; on the CPU's ranges the embeddings
    within 1e-3 rel. L2 and the branch outputs' s8 values equal."""
    import numpy as np
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.ops.quant import int8_calibration, int8_inference
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_config()
    cfg.model.compute_dtype = 'float32'
    cfg.model.bpbreid.backbone = 'hrnet32'
    cfg.model.bpbreid.masks.parts_num = 5
    cfg.model.bpbreid.dim_reduce_output = 64
    cfg.model.bpbreid.use_pallas_pooling = True
    cfg.model.bpbreid.multires_pooling = False
    stages = {'stage2': (1, 2, (1, 1), (32, 64)),
              'stage3': (1, 3, (1, 1, 1), (32, 64, 128)),
              'stage4': (1, 4, (1, 1, 1, 1), (32, 64, 128, 256))}
    var = float(np.float32(np.float32(1.0) - np.float32(1e-5)))
    x = torch.randn(2, 3, 64, 32, generator=torch.Generator().manual_seed(0))
    models, outs, ranges, branch = {}, {}, {}, {}
    for device in ('cpu', 'cuda'):
        model = build_model('bpbreid', 7, config=cfg, device=device, seed=0,
                            backbone_stages=stages)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, FastBatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(var)
                    if m.bias is not None:
                        m.bias.zero_()
                    m.weight.copy_(1 + 0.2 * torch.randn(
                        m.weight.shape, generator=gen).to(device))
        with torch.inference_mode(), int8_calibration(99.9):
            model(x.to(device))
        ranges[device] = {(n, k): b.cpu() for n, m in model.named_modules()
                          for k, b in m._buffers.items() if 'amax' in k}
        models[device] = model
    assert ranges['cpu'].keys() == ranges['cuda'].keys()
    for key, a in ranges['cpu'].items():
        err = (ranges['cuda'][key] - a).abs().max() \
            / a.abs().max().clamp(min=1e-12)
        assert err.item() <= 1e-5, (key, err.item())
    for (n, k), b in ranges['cpu'].items():
        models['cuda'].get_submodule(n).register_buffer(
            k, b.to(cuda), persistent=False)
    before = launch_counts['conv_s8']
    for device, model in models.items():
        caps = {}
        hooks = [m.register_forward_hook(
            lambda mod, _, out, name=name: caps.__setitem__(name, out.q))
            for name, m in model.named_modules()
            if name.rsplit('.', 2)[-2:-1] == ['branches']]
        with torch.inference_mode(), int8_inference(skip_patterns=()):
            outs[device] = model(x.to(device))[0]['bn_foreg'].cpu()
        for h in hooks:
            h.remove()
        branch[device] = {k: v.cpu() for k, v in caps.items()}
    assert launch_counts['conv_s8'] > before
    assert branch['cpu'] and all(torch.equal(branch['cuda'][k], v)
                                 for k, v in branch['cpu'].items())
    err = (outs['cuda'] - outs['cpu']).norm() / outs['cpu'].norm()
    assert err.item() <= 1e-3


@pytest.mark.parametrize('engine_name', ['softmax', 'triplet'])
def test_video_step_on_the_card_matches_the_cpu(cuda, engine_name,
                                                 monkeypatch):
    """One f32 train step of a video engine on synthetic tracklets
    ([4, 3] frames of 64x32 -> 12 frames through osnet_x0_25): the card's
    loss equals the CPU's (TF32 off) to 1e-4 relative, and the step
    launches the BN kernels once per ``FastBatchNorm`` call; the pooled
    tracklet embeddings of a test batch (before the step) equal the
    CPU's to 1e-3."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.data.video import VideoDataManager
    from bpbreid_tpu_torch.engine.video import (VideoSoftmaxEngine,
                                               VideoTripletEngine)
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.optim import build_optimizer
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    cls = {'softmax': VideoSoftmaxEngine,
           'triplet': VideoTripletEngine}[engine_name]
    dm = VideoDataManager(sources=['synthetic_video'], height=64, width=32,
                          transforms=[], batch_size_train=4,
                          batch_size_test=4, workers=1, num_instances=2,
                          train_sampler='RandomIdentitySampler', seq_len=3)
    batch = next(iter(dm.train_loader))
    query = next(iter(dm.test_loader['synthetic_video']['query']))
    out = {}
    for device in ('cuda', 'cpu'):
        model = build_model('osnet_x0_25', dm.num_train_pids,
                            loss=engine_name, device=device, seed=0,
                            dtype=torch.float32)
        engine = cls(dm, model, build_optimizer(model, optim='adam'),
                     config=get_default_config(), device=device)
        calls = []
        for m in model.modules():
            if isinstance(m, FastBatchNorm):
                m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
        feats = engine.feature_extraction([query])[0].cpu()
        calls.clear()
        before = dict(launch_counts)
        loss, _ = engine.forward_backward(batch)
        loss = loss.item()
        if device == 'cuda':
            torch.cuda.synchronize()
            assert calls
            for k in ('bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx'):
                assert launch_counts[k] - before.get(k, 0) == len(calls), k
        out[device] = loss, feats
    assert out['cuda'][0] == pytest.approx(out['cpu'][0], rel=1e-4)
    assert out['cuda'][1].shape == (4, 512)
    tol = 1e-3 * out['cpu'][1].abs().max().item()
    assert (out['cuda'][1] - out['cpu'][1]).abs().max().item() <= tol


def test_ro_train_loader_feeds_the_card(cuda):
    """The ``ro`` random occlusion in the train loader (host) and the
    part-based train step on the card: each occluded batch arrives on the
    card bit for bit through the prefetch, and the loss is finite."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.data.datamanager import ImageDataManager
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.engine.engine import device_prefetch
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.optim import build_optimizer
    cfg = get_default_config()
    cfg.data.ro.p = 1.0
    cfg.data.transforms = ['rf', 'ro']
    cfg.model.bpbreid.backbone = 'resnet18'
    cfg.model.bpbreid.masks.parts_num = 5
    clear_dataset_cache()
    dm = ImageDataManager(config=cfg, sources='synthetic', height=64,
                          width=32, transforms=['rf', 'ro'],
                          batch_size_train=8, num_instances=4, workers=2,
                          use_masks=True, masks_dir='pifpaf')
    host = list(dm.train_loader)
    model = build_model('bpbreid', dm.num_train_pids, config=cfg,
                        device=cuda, seed=0)
    engine = ImagePartBasedEngine.from_config(
        cfg, model, dm.mask_chain_kwargs(), device=cuda,
        optimizer=build_optimizer(model, optim='adam'))
    assert len(host) > 1
    for want, got in zip(host, device_prefetch(host, cuda)):
        assert torch.equal(got['image'].cpu(),
                           torch.from_numpy(want['image']))
        loss, _ = engine.forward_backward(got)
        assert torch.isfinite(loss).item()
