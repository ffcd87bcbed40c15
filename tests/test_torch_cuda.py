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
                                   (64, 1920, 96, 32, 6), (1, 7, 13, 11, 64),
                                   # the zoo backbones' maps at 384x128:
                                   # nasnetamobile, shufflenet,
                                   # mobilenetv2_x1_0
                                   (64, 1056, 12, 4, 6), (64, 960, 12, 4, 6),
                                   (64, 1280, 12, 4, 6),
                                   # fastreid_resnet_ibn_nl's map; the
                                   # 'eight' (K+1 = 9) and isp_6_parts
                                   # (7) masks; slices of a ragged map,
                                   # K+1 = 17; K+1 = 64 in
                                   # sub-chunks of pixels, and in chunks
                                   # of channels
                                   (64, 2048, 24, 8, 6),
                                   (8, 1920, 96, 32, 9), (5, 64, 17, 9, 7),
                                   (3, 40, 33, 29, 17), (2, 500, 96, 32, 64),
                                   (132, 500, 8, 8, 64)])
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attention_pool_kernel_gives_the_same_bits_twice(cuda, dtype):
    """The slices' sums meet in a fixed order: two calls on the main
    shape give the same bits."""
    from bpbreid_tpu_torch.ops.cuda.pooling import fused_attention_pool
    gen = torch.Generator(device=cuda).manual_seed(1)
    feats = torch.randn(64, 1920, 96, 32, device=cuda, generator=gen) \
        .to(dtype)
    logits = (3 * torch.randn(64, 6, 96, 32, device=cuda, generator=gen)) \
        .to(torch.bfloat16)
    for a, b in zip(fused_attention_pool(feats, logits),
                    fused_attention_pool(feats, logits)):
        assert torch.equal(a, b)


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
# the legacy zoo's: NASNet's odd stem widths (11, 22, 44) at odd maps,
# ShuffleNet's 60-wide bottleneck, MLFN's pooled gates [N, 32, 1, 1],
# HACNN's one-channel spatial attention, NASNet's 1056-wide map, MuDeep's
# 4096-wide BN1d head
K3_SHAPES += [((8, 11, 63, 31), 1), ((8, 22, 32, 16), 1),
              ((8, 44, 16, 8), 1), ((8, 60, 32, 16), 1), ((8, 32, 1, 1), 1),
              ((8, 1, 20, 8), 1), ((8, 1056, 4, 2), 1), ((8, 4096), -1)]


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


@pytest.mark.parametrize('shape,channel_dim', [((8, 11, 63, 31), 1),
                                               ((8, 44, 16, 8), 1),
                                               ((8, 4096), -1)])
def test_bn_epilogue_at_eps_1e3_matches_plain(cuda, shape, channel_dim):
    """The eps of InceptionV4's, Inception-ResNet-V2's and NASNet's BNs
    (1e-3) in ``bn_stats``'s epilogue and ``bn_apply``, against the plain
    versions."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_apply, bn_apply_reference, bn_finalize_reference, bn_stats,
        channel_view)
    x, _ = _k3_inputs(cuda, shape, torch.bfloat16, 4)
    a, c, b = channel_view(x.shape, channel_dim)
    weight = torch.linspace(0.5, 1.5, c, device=cuda)
    got = bn_stats(x, weight, 1e-3, channel_dim, sums=True)
    want = bn_finalize_reference(got[4], got[5], a * b, weight, 1e-3)
    for g, w in zip(got[:4], want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    eps5 = bn_stats(x, weight, 1e-5, channel_dim)
    assert not torch.equal(eps5[2], got[2])
    y = bn_apply(x, got[0], got[2], weight, None, channel_dim,
                 torch.bfloat16)
    assert torch.equal(y, bn_apply_reference(x, got[0], got[2], weight, None,
                                             channel_dim, torch.bfloat16))


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


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
@pytest.mark.parametrize('world', [1, 2, 4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bn_apply_sums_kernel_matches_plain(cuda, shape, channel_dim, world,
                                            dtype):
    """bn_apply_sums (the cross-rank BN's forward from all-reduced sums)
    on the sums of ``world`` equal slices, with the global count, against
    its plain version: the statistics and the running update to 1e-6
    relative, y to one ulp plus 1e-6 of its terms on the plain
    statistics, the same bits over two calls, one launch each (counted
    once, as bn_apply_sums); at world 1 on bn_stats's own sums it gives bn_stats's
    statistics and bn_apply's output bit for bit."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_apply, bn_apply_reference, bn_apply_sums, bn_finalize_reference,
        channel_view)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, _ = _k3_inputs(cuda, shape, dtype, 5)
    a, c, b = channel_view(x.shape, channel_dim)
    weight, bias, st = _stats(cuda, x, channel_dim)
    sums = torch.stack(st[4:]) * world
    m = a * b * world
    rm = torch.linspace(-1, 1, c, device=cuda)
    rv = torch.linspace(0.5, 2, c, device=cuda)
    runs = []
    before = dict(launch_counts)
    for _ in range(2):
        rm_k, rv_k = rm.clone(), rv.clone()
        y, stats = bn_apply_sums(x, sums, m, weight, bias, 1e-5, channel_dim,
                                 running_mean=rm_k, running_var=rv_k)
        runs.append((y,) + stats + (rm_k, rv_k))
    torch.cuda.synchronize()
    assert launch_counts['bn_apply_sums'] == \
        before.get('bn_apply_sums', 0) + 2
    assert sum(launch_counts.values()) == sum(before.values()) + 2
    rm_p, rv_p = rm.clone(), rv.clone()
    want = bn_finalize_reference(sums[0], sums[1], m, weight, 1e-5, rm_p,
                                 rv_p) + (rm_p, rv_p)
    for g, g2, w in zip(runs[0][1:], runs[1][1:], want):
        assert torch.equal(g, g2)
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    assert torch.equal(runs[0][0], runs[1][0])
    mean, rstd, scale = want[0], want[2], want[3]
    x3 = x.reshape(a, c, b).float()
    terms = ((x3 - mean.view(1, c, 1)).abs() * scale.abs().view(1, c, 1)
             + bias.abs().view(1, c, 1)).view(x.shape)
    _ew_close(runs[0][0], bn_apply_reference(x, mean, rstd, weight, bias,
                                             channel_dim), terms)
    if world == 1:
        y, stats = bn_apply_sums(x, sums, m, weight, bias, 1e-5, channel_dim)
        for g, w in zip(stats, st[:4]):
            assert torch.equal(g, w)
        assert torch.equal(y, bn_apply(x, st[0], st[2], weight, bias,
                                       channel_dim))


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
def test_bn_local_sums_kernel_matches_bn_stats(cuda, shape, channel_dim):
    """bn_local_sums (the sums a rank all-reduces) is one bn_stats launch:
    a contiguous f32 [2, C] with bn_stats's sums bit for bit (held
    against the plain sums in test_bn_stats_kernels_match_plain)."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import bn_local_sums
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, _ = _k3_inputs(cuda, shape, torch.bfloat16, 5)
    weight, _, st = _stats(cuda, x, channel_dim)
    before = launch_counts['bn_stats']
    got = bn_local_sums(x, weight, 1e-5, channel_dim)
    assert launch_counts['bn_stats'] == before + 1
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (2, weight.numel())
    assert torch.equal(got, torch.stack(st[4:]))


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
def test_bn_grad_local_sums_kernel_matches_bn_grad_stats(cuda, shape,
                                                         channel_dim):
    """bn_grad_local_sums (the backward's sums, a copy of which a rank
    all-reduces in place) is one bn_grad_stats launch: its own sums and
    the contiguous f32 [2, C] copy both bn_grad_stats's bit for bit."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_grad_local_sums,
                                                      bn_grad_stats)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    x, dy = _k3_inputs(cuda, shape, torch.bfloat16, 7)
    _, _, (mean, _, rstd, _, _, _) = _stats(cuda, x, channel_dim)
    want = bn_grad_stats(dy, x, mean, rstd, channel_dim)
    before = dict(launch_counts)
    sum_dy, sum_dy_xhat, sums = bn_grad_local_sums(dy, x, mean, rstd,
                                                   channel_dim)
    assert launch_counts['bn_grad_stats'] == \
        before.get('bn_grad_stats', 0) + 1
    assert sum(launch_counts.values()) == sum(before.values()) + 1
    assert sums.dtype == torch.float32 and sums.is_contiguous()
    assert sums.shape == (2, mean.numel())
    assert torch.equal(sum_dy, want[0]) and torch.equal(sum_dy_xhat, want[1])
    assert torch.equal(sums, torch.stack(want))


@pytest.mark.parametrize('shape,channel_dim', K3_SHAPES)
@pytest.mark.parametrize('world', [2, 4])
def test_bn_dx_with_a_count_matches_plain(cuda, shape, channel_dim, world):
    """bn_dx with the global count of ``world`` ranks (the sums
    all-reduced) against bn_dx_reference with the same count: one ulp
    plus 1e-6 of the terms, the same bits over two calls."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_dx,
                                                      bn_dx_reference,
                                                      bn_grad_stats,
                                                      channel_view)
    x, dy = _k3_inputs(cuda, shape, torch.bfloat16, 6)
    a, c, b = channel_view(x.shape, channel_dim)
    _, _, (mean, _, rstd, scale, _, _) = _stats(cuda, x, channel_dim)
    sum_dy, sum_dy_xhat = (t * world for t in bn_grad_stats(
        dy, x, mean, rstd, channel_dim))
    m = a * b * world
    got = [bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat,
                 channel_dim, m) for _ in range(2)]
    assert torch.equal(got[0], got[1])
    want = bn_dx_reference(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat,
                           channel_dim, m=m)
    x3 = x.reshape(a, c, b).float()
    xhat = (x3 - mean.view(1, c, 1)) * rstd.view(1, c, 1)
    terms = scale.abs().view(1, c, 1) * (
        dy.reshape(a, c, b).float().abs() + (sum_dy.abs() / m).view(1, c, 1)
        + (xhat * sum_dy_xhat.view(1, c, 1) / m).abs())
    _ew_close(got[0], want, terms.view(x.shape))
    local = bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat,
                  channel_dim)
    assert not torch.equal(local, got[0])


def test_bn_apply_sums_and_count_refuse_bad_inputs(cuda):
    from bpbreid_tpu_torch.ops.cuda.batchnorm import bn_apply_sums, bn_dx
    w = torch.ones(8, device=cuda)
    sums = torch.ones(2, 8, device=cuda)
    x = torch.zeros(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums.t().contiguous().t(), 4, w)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums.double(), 4, w)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums[:, :4].contiguous(), 4, w)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums.cpu(), 4, w)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums, 0, w)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums, 2 ** 31, w)
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums, 4, w[:4])
    with pytest.raises(ValueError):
        bn_apply_sums(x, sums, 4, w, bias=w.double())
    with pytest.raises(ValueError):          # one running buffer alone
        bn_apply_sums(x, sums, 4, w, running_mean=w.clone())
    with pytest.raises(TypeError):
        bn_apply_sums(x, sums, 4, w, dtype=torch.float16)
    with pytest.raises(ValueError):
        bn_dx(x, x, w, w, w, w, w, 1, 0)


def test_cross_rank_batch_norm_at_world_1_is_the_plain_batch_norm(
        cuda, tmp_path):
    """FastBatchNorm under a one-rank gloo mesh on the card: bn_stats
    (sums) -> all_reduce -> bn_apply_sums forward, bn_grad_stats (the sums
    twice) -> all_reduce of the copy in place -> bn_dx backward: two
    launches each way, bit-equal to the same module without a mesh (f32
    and bf16)."""
    import torch.distributed as dist
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.parallel.mesh import (collective_counts,
                                                 init_process_group)
    mesh = init_process_group(0, 1, 'file://{}'.format(tmp_path / 'rdv'),
                              'gloo', cuda)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = _k3_inputs(cuda, (8, 16, 12, 5), dtype, 1)
            out = []
            for use_mesh in (False, True):
                bn = FastBatchNorm(16, dtype=dtype).train().to(cuda)
                with torch.no_grad():
                    bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
                    bn.bias.fill_(0.1)
                bn.mesh = mesh if use_mesh else None
                xi = x.detach().clone().requires_grad_(True)
                before = dict(launch_counts)
                reduces = collective_counts['all_reduce']
                y = bn(xi)
                y.backward(dy)
                torch.cuda.synchronize()
                if use_mesh:
                    for name in ('bn_stats', 'bn_apply_sums',
                                 'bn_grad_stats', 'bn_dx'):
                        assert launch_counts[name] == \
                            before.get(name, 0) + 1, name
                    # no plain bn_apply: each launch counted once
                    assert launch_counts['bn_apply'] == \
                        before.get('bn_apply', 0)
                    assert sum(launch_counts.values()) == \
                        sum(before.values()) + 4
                    assert collective_counts['all_reduce'] == reduces + 2
                out.append([t.detach() for t in (
                    y, xi.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var)])
            for a, b in zip(*out):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


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
    from bpbreid_tpu_torch.engine.graphs import replayed_counter
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
    # grouped eval replays a CUDA graph: its replays repeat the calls
    # the capture made, counted as the launch counts are
    with replayed_counter(calls):
        engine.run(max_epoch=1, test_only=False,
                   save_dir=cfg.data.save_dir)
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


def test_affine_grid_sample_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """HACNN's spatial transformer on the card (bf16 maps sampled in f32)
    against the CPU, f32: the samples and the gradients with respect to
    the map and ``theta`` to 1e-5 of their largest magnitude."""
    from bpbreid_tpu_torch.ops.grid_sample import affine_grid_sample
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 80, 32, generator=gen)
    theta = torch.zeros(4, 2, 3)
    theta[:, 0, 0], theta[:, 1, 1] = 1.0, 0.25
    theta[:, :, 2] = 2.4 * torch.rand(4, 2, generator=gen) - 1.2
    w = torch.randn(4, 32, 80, 32, generator=gen)
    out = {}
    for dev in (cuda, torch.device('cpu')):
        xd = x.to(dev).requires_grad_(True)
        td = theta.to(dev).requires_grad_(True)
        y = affine_grid_sample(xd, td)
        (y * w.to(dev)).sum().backward()
        out[dev.type] = [t.detach().cpu() for t in (y, xd.grad, td.grad)]
    for a, b in zip(out['cuda'], out['cpu']):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max() + 1e-6
    y = affine_grid_sample(x.to(cuda).bfloat16(), theta.to(cuda))
    assert y.dtype == torch.bfloat16
    assert (y.float().cpu() - out['cpu'][0]).abs().max() <= \
        2 ** -7 * out['cpu'][0].abs().max() + 0.02


def test_compact_bilinear_pooling_on_the_card_matches_the_cpu(cuda):
    """The count sketch (``index_add``) and the FFT product on the card,
    with the sketch parameters made there from the same numpy seed."""
    from bpbreid_tpu_torch.ops.compact_bilinear_pooling import \
        CompactBilinearPooling
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(64, 512, generator=gen)
    y = torch.randn(64, 256, generator=gen)
    card = CompactBilinearPooling(512, 256, 1024, seed=3)
    cpu = CompactBilinearPooling(512, 256, 1024, seed=3, device='cpu')
    assert card.hx.device.type == 'cuda'
    assert torch.equal(card.hx.cpu(), cpu.hx)
    got = card(x.to(cuda), y.to(cuda)).cpu()
    want = cpu(x, y)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# one model of each module of the legacy zoo (and PCB, PVPM), with the
# input each takes: (name, height, width)
ZOO_CARD_MODELS = [
    ('pcb_p4', 96, 32), ('pose_p4', 64, 32), ('se_resnet50', 64, 32),
    ('densenet121', 64, 32), ('mobilenetv2_x1_0', 64, 32),
    ('shufflenet', 64, 32), ('shufflenet_v2_x0_5', 64, 32),
    ('squeezenet1_0', 64, 32), ('mlfn', 64, 32), ('xception', 96, 64),
    ('inceptionv4', 160, 96), ('inceptionresnetv2', 160, 96),
    ('nasnetamobile', 128, 64), ('mudeep', 256, 128), ('hacnn', 160, 64)]


@pytest.mark.parametrize('name, h, w', ZOO_CARD_MODELS)
def test_zoo_model_on_the_card_matches_the_cpu(cuda, monkeypatch, name, h,
                                               w):
    """The same seeded f32 model on the card and the CPU (TF32 off), eval
    mode on 4 images: outputs to 1e-3 of the largest magnitude. Then on
    the card a train-mode forward and backward of the outputs' sum
    launches the four BN kernels once per ``FastBatchNorm`` call, and an
    eval batch one ``bn_apply`` a call (PCB's and PVPM's train-mode heads
    make fewer calls in eval mode)."""
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import (FastBatchNorm,
                                                 set_dropout_generator)
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    gen = torch.Generator().manual_seed(2)
    inputs = [torch.randn(4, 3, h, w, generator=gen)]
    if name.startswith('pose_'):
        inputs.append(torch.rand(4, 56, h // 4, w // 4, generator=gen))

    def leaves(out):
        if isinstance(out, (list, tuple)):
            return [t for o in out for t in leaves(o)]
        return [out]
    out = {}
    for dev in ('cuda', 'cpu'):
        model = build_model(name, 10, loss='softmax', device=dev, seed=0,
                            dtype=torch.float32)
        with torch.no_grad():
            out[dev] = [t.cpu() for t in leaves(model(*[
                t.to(dev) for t in inputs]))]
    for a, b in zip(out['cuda'], out['cpu']):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max() + 1e-6
    calls = []
    for m in model.modules():
        if isinstance(m, FastBatchNorm):
            m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
    model = model.to(cuda).train()
    set_dropout_generator(model, torch.Generator(cuda).manual_seed(0))
    before = dict(launch_counts)
    outs = leaves(model(*[t.to(cuda) for t in inputs]))
    sum(o.float().sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert all(torch.isfinite(o).all() for o in outs)
    n = len(calls)
    assert n > 0 or name == 'squeezenet1_0'
    for kernel in ('bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx'):
        assert launch_counts[kernel] - before.get(kernel, 0) == n, kernel
    calls.clear()
    before = dict(launch_counts)
    with torch.inference_mode():
        model.eval()(*[t.to(cuda) for t in inputs])
    assert launch_counts['bn_apply'] - before.get('bn_apply', 0) \
        == len(calls) <= n
    assert launch_counts['bn_stats'] == before.get('bn_stats', 0)


def test_debug_forward_launches_on_a_reduced_model(cuda, tmp_path):
    """The debug figures' forward (``train.batch_debug_freq``) on the
    serving configuration at 64x32 (resnet18, K2, multires off): one K2
    and one ``bn_apply`` per eval-mode BN call (forward hooks), no other
    kernel; five figures; the model back in train mode."""
    import numpy as np
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    cfg = _serving_config()
    cfg.data.save_dir = str(tmp_path)
    model = build_model('bpbreid', 4, config=cfg, device=cuda, seed=0)
    engine = ImagePartBasedEngine.from_config(
        cfg, model, mask_kwargs=None, device=cuda)
    rng = np.random.default_rng(0)
    batch = {'image': rng.integers(0, 256, (8, 64, 32, 3), dtype=np.uint8),
             'pid': np.repeat(np.arange(2), 4)}
    calls = []
    for m in model.modules():
        if isinstance(m, FastBatchNorm):
            m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
    model.train()
    torch.cuda.synchronize()
    reset_launch_counts()
    paths = engine._debug_visualize_batch(batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts.items() if v}
    assert counts == {'attention_pool': 1, 'bn_apply': len(calls)}
    assert len(paths) == 5 and model.training


def test_native_ranker_on_card_made_features(cuda):
    """Distances computed on the card from card-made features, ranked by
    the native C++ ranker and by the numpy path: equal to 1e-6."""
    from bpbreid_tpu_torch.metrics.distance import \
        compute_distance_matrix_using_bp_features
    from bpbreid_tpu_torch.metrics.rank import evaluate_rank
    gen = torch.Generator(device=cuda).manual_seed(1)
    qf = torch.nn.functional.normalize(
        torch.randn(60, 3, 32, device=cuda, generator=gen), dim=-1)
    gf = torch.nn.functional.normalize(
        torch.randn(400, 3, 32, device=cuda, generator=gen), dim=-1)
    d, _ = compute_distance_matrix_using_bp_features(qf, gf, None, None,
                                                     'mean', 100)
    d = d.cpu().numpy()
    g = torch.Generator().manual_seed(2)
    q_pids = torch.randint(0, 30, (60,), generator=g).numpy()
    g_pids = torch.randint(0, 30, (400,), generator=g).numpy()
    q_cam = torch.randint(0, 4, (60,), generator=g).numpy()
    g_cam = torch.randint(0, 4, (400,), generator=g).numpy()
    nat = evaluate_rank(d, q_pids, g_pids, q_cam, g_cam)
    plain = evaluate_rank(d, q_pids, g_pids, q_cam, g_cam, use_native=False)
    assert abs(nat['mAP'] - plain['mAP']) <= 1e-6
    assert float(abs(nat['cmc'] - plain['cmc']).max()) <= 1e-6


def test_model_complexity_on_the_card(cuda):
    """``compute_model_complexity`` of a model on the card: the CPU copy's
    parameter count and FLOPs. Plain pooling: K2 on the card is a kernel
    FlopCounterMode does not see, its plain version on the CPU a
    counted product."""
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.utils.model_complexity import \
        compute_model_complexity
    cfg = _serving_config()
    cfg.model.bpbreid.use_pallas_pooling = False
    card = build_model('bpbreid', 4, config=cfg, device=cuda, seed=0)
    cpu = build_model('bpbreid', 4, config=cfg, device='cpu', seed=0)
    got = compute_model_complexity(card, cfg)
    assert got == compute_model_complexity(cpu, cfg)
    assert got[0] == sum(p.numel() for p in card.parameters())
    assert got[1] > 0 and not card.training


def test_profile_summary_of_a_cuda_trace(cuda, tmp_path):
    """``tools/profile_summary.py`` on a short CUDA trace: its total is
    the profiler's own CUDA total (1 %), the convolution and batch-norm
    categories are there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bpbreid_tpu_torch.tools import profile_summary
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 16, 3),
                                torch.nn.BatchNorm2d(16),
                                torch.nn.ReLU()).to(cuda)
    x = torch.randn(8, 3, 64, 32, device=cuda)
    model(x).sum().backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model(x).sum().backward()
        torch.cuda.synchronize()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    rows, cats, total_ns, label = profile_summary.summarize(path)
    own_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False))
    assert label.startswith('device') and own_us > 0
    assert abs(total_ns / 1e3 - own_us) <= 0.01 * own_us
    assert cats['convolution'] > 0 and cats['batch norm'] > 0


# grouped dispatch through CUDA graphs (engine/graphs.py): the smoke
# config's BPBReID (resnet18 at 64x32, batch 8, f32, capturable Adam)
def _graph_engine(tmp_path, *opts):
    import os
    import types
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.scripts import main as cli
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clear_dataset_cache()
    cfg = cli.build_config(
        types.SimpleNamespace(save_dir=str(tmp_path), job_id=1, opts=[
            'model.compute_dtype', 'float32', 'data.transforms',
            "['rf', 'rc', 're']"] + list(opts)),
        os.path.join(repo, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml'))
    engine, _model = cli.build_model_engine(cfg)
    return engine


def _graph_batches(engine, k):
    import itertools
    import numpy as np
    batches = list(itertools.islice(
        itertools.cycle(engine.datamanager.train_loader), k))
    stacked = {key: torch.as_tensor(np.stack([b[key] for b in batches]))
               .cuda() for key in ('image', 'mask', 'pid')}
    return batches, stacked


def _train_snapshot(engine):
    import copy
    return ({k: v.clone() for k, v in engine.model.state_dict().items()},
            copy.deepcopy(engine.optimizer.state_dict()),
            engine.generator.get_state())


def _train_restore(engine, snap):
    # the optimizer gets a copy: load_state_dict keeps tensors that fit
    import copy
    from bpbreid_tpu_torch.utils.checkpoint import load_optimizer_state
    engine.model.load_state_dict(snap[0])
    load_optimizer_state(engine.optimizer, copy.deepcopy(snap[1]))
    engine.generator.set_state(snap[2])


def _train_state(engine):
    out = {'param.' + n: p.detach().clone()
           for n, p in engine.model.named_parameters()}
    out.update({'buffer.' + n: b.clone()
                for n, b in engine.model.named_buffers()})
    for i, p in enumerate(engine.model.parameters()):
        for k, v in engine.optimizer.state[p].items():
            out['adam.{}.{}'.format(i, k)] = v.clone()
    return out


def test_graph_steps_equal_eager_steps(cuda, tmp_path, monkeypatch):
    """k = 4 steps through the train step's CUDA graph (an eager step,
    a capture and its replay, two replays) against 4 eager steps from
    the same state, twice, with cuDNN's deterministic algorithms (its
    default backward sums with atomics): losses, parameters, BN
    statistics, Adam's moments and the generator's state (the
    augmentation's and the dropout's draws) bit-equal wherever the two
    eager runs are, else within 4 times their own difference."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    engine = _graph_engine(tmp_path)
    assert engine.train_graphs
    batches, stacked = _graph_batches(engine, 4)
    snap = _train_snapshot(engine)
    runs = []
    for _ in range(2):
        _train_restore(engine, snap)
        losses = torch.stack([engine.forward_backward(b)[0]
                              for b in batches])
        torch.cuda.synchronize()
        runs.append((losses, _train_state(engine),
                     engine.generator.get_state()))
    _train_restore(engine, snap)
    losses, summary = engine.forward_backward_multi(stacked)
    torch.cuda.synchronize()
    graph = engine._train_graph
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 1, 3)
    state = _train_state(engine)
    (l_a, s_a, g_a), (l_b, s_b, g_b) = runs
    assert torch.equal(engine.generator.get_state(), g_a)
    for name, got, a, b in [('loss', losses, l_a, l_b)] + [
            (k, state[k], s_a[k], s_b[k]) for k in s_a]:
        if torch.equal(a, b):
            assert torch.equal(got, a), name
        else:
            spread = (b - a).abs().max().item()
            assert (got - a).abs().max().item() <= 4 * spread, name
    leaves = [v for group in summary.values() for v in group.values()]
    assert leaves and all(tuple(v.shape) == (4,) for v in leaves)


def test_graph_recaptures_on_lr_and_frozen_base(cuda, tmp_path):
    """The CLI's Adam on the card is capturable. A new lr or frozen-base
    flag re-keys the graph: an eager step, then a new capture; the same
    key replays."""
    engine = _graph_engine(tmp_path)
    assert all(g['capturable'] for g in engine.optimizer.param_groups)
    _batches, stacked = _graph_batches(engine, 3)
    engine.forward_backward_multi(stacked)
    graph = engine._train_graph
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 1, 2)
    engine.forward_backward_multi(stacked)
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 1, 5)
    for group in engine.optimizer.param_groups:
        group['lr'] *= 0.1
    engine.forward_backward_multi(stacked)
    assert (graph.eager_steps, graph.captures, graph.replays) == (2, 2, 7)
    engine.set_freeze_base(True)
    engine.forward_backward_multi(stacked)
    assert (graph.eager_steps, graph.captures, graph.replays) == (3, 3, 9)
    torch.cuda.synchronize()


def test_graph_replays_add_the_captured_launch_counts(cuda, tmp_path):
    """Each replay adds the BN launches its capture made: k grouped
    steps count k times an eager step's launches."""
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    engine = _graph_engine(tmp_path)
    batches, stacked = _graph_batches(engine, 5)
    reset_launch_counts()
    engine.forward_backward(batches[0])
    one = dict(launch_counts)
    assert one.get('bn_stats', 0) > 0
    reset_launch_counts()
    engine.forward_backward_multi(stacked)
    torch.cuda.synchronize()
    assert engine._train_graph.replays == 4
    assert dict(launch_counts) == {k: 5 * v for k, v in one.items()}


def test_graph_capture_failure_raises(cuda, tmp_path, monkeypatch):
    """A step that fails while it is captured raises out of
    ``forward_backward_multi``: no eager step is taken in its place."""
    engine = _graph_engine(tmp_path)
    _batches, stacked = _graph_batches(engine, 3)
    step = engine.train_step

    def failing(*inputs, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError('refused while capturing')
        return step(*inputs, **kwargs)
    monkeypatch.setattr(engine, 'train_step', failing)
    engine._train_graph = None
    with pytest.raises(ValueError, match='refused while capturing'):
        engine.forward_backward_multi(stacked)
    graph = engine._train_graph
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 0, 0)
    torch.cuda.synchronize()


def test_capturable_adam_checkpoint_loads_into_an_eager_engine(cuda,
                                                               tmp_path):
    """A graph engine's checkpoint (capturable Adam, step counts on the
    card) loads into an engine of eager steps (Adam without
    ``capturable``, step counts on the host), which trains on; its
    checkpoint loads back into the graph engine, which replays."""
    from bpbreid_tpu_torch.utils.checkpoint import (resume_from_checkpoint,
                                                    save_checkpoint)
    graph = _graph_engine(tmp_path / 'g')
    eager = _graph_engine(tmp_path / 'e')
    # build_optimizer makes a card's Adam capturable: the eager engine's
    # is built without
    eager.optimizer = torch.optim.Adam(
        eager.model.parameters(), lr=graph.optimizer.param_groups[0]['lr'],
        weight_decay=5e-4)
    assert graph.train_graphs and not eager.train_graphs
    batches, stacked = _graph_batches(graph, 3)
    graph.forward_backward_multi(stacked)
    path = save_checkpoint(graph.model, graph.optimizer, {'epoch': 0},
                           str(tmp_path / 'ckpt'), epoch=0)
    resume_from_checkpoint(path, eager.model, eager.optimizer)
    for pg, pe in zip(graph.model.parameters(), eager.model.parameters()):
        assert torch.equal(pg, pe)
        sg, se = graph.optimizer.state[pg], eager.optimizer.state[pe]
        assert torch.equal(sg['exp_avg'], se['exp_avg'])
        assert se['step'].device.type == 'cpu' and float(se['step']) == 3
        assert sg['step'].device.type == 'cuda'
    assert not any(g['capturable'] for g in eager.optimizer.param_groups)
    assert torch.isfinite(eager.forward_backward(batches[0])[0])
    path = save_checkpoint(eager.model, eager.optimizer, {'epoch': 1},
                           str(tmp_path / 'ckpt'), epoch=1)
    resume_from_checkpoint(path, graph.model, graph.optimizer)
    assert all(g['capturable'] for g in graph.optimizer.param_groups)
    losses, _ = graph.forward_backward_multi(stacked)
    assert graph._train_graph.eager_steps == 2      # re-keyed by the load
    assert torch.isfinite(losses).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize('rule', ['amsgrad', 'rmsprop', 'radam'])
def test_optax_rules_on_the_card_are_captured(cuda, rule):
    """amsgrad, rmsprop and radam over CUDA parameters keep each
    group's step count as a float32 tensor on the card, and the engine's
    rule takes them into the train graph."""
    from bpbreid_tpu_torch.engine.engine import Engine
    from bpbreid_tpu_torch.optim import build_optimizer
    engine = Engine()
    engine.device = cuda
    engine.model = torch.nn.Linear(3, 2).to(cuda)
    engine.optimizer = build_optimizer(engine.model, optim=rule,
                                       staged_lr=True, new_layers=['bias'])
    for g in engine.optimizer.param_groups:
        assert g['step'].device.type == 'cuda'
        assert g['step'].dtype == torch.float32
    assert engine.train_graphs


def _osnet_graph_engine(tmp_path):
    """``osnet_x1_0`` under the softmax engine with torchreid's recipe
    (amsgrad, random flip, label smoothing) at 64x32, batch 8, f32."""
    import types
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.scripts import main as cli
    clear_dataset_cache()
    cfg = cli.build_config(types.SimpleNamespace(
        save_dir=str(tmp_path), job_id=1, opts=[
            'model.compute_dtype', 'float32', 'data.sources',
            "['synthetic']", 'data.targets', "['synthetic']",
            'data.height', '64', 'data.width', '32', 'data.transforms',
            "['random_flip']", 'loss.name', 'softmax', 'model.name',
            'osnet_x1_0', 'train.optim', 'amsgrad', 'train.lr', '0.0015',
            'train.batch_size', '8', 'sampler.num_instances', '4']), None)
    return cli.build_model_engine(cfg)[0]


def test_osnet_amsgrad_graph_steps_equal_eager_steps(cuda, tmp_path,
                                                     monkeypatch):
    """A group of 3 ``osnet_x1_0`` amsgrad steps through the train graph
    (an eager step, a capture and its replay, a replay) against 3 eager
    steps from the same state, twice, with cuDNN's deterministic
    algorithms: losses, parameters, BN statistics, amsgrad's moments and
    the generator's state bit-equal wherever the two eager runs are,
    else within 4 times their own difference; the step count reads 3, so
    the replays advanced it (a count frozen at the capture's 2 moves the
    third update by about 15 %)."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    engine = _osnet_graph_engine(tmp_path)
    assert engine.train_graphs
    import itertools
    import numpy as np
    batches = list(itertools.islice(
        itertools.cycle(engine.datamanager.train_loader), 3))
    stacked = {key: torch.as_tensor(np.stack([b[key] for b in batches]))
               .cuda() for key in ('image', 'pid')}
    snap = _train_snapshot(engine)
    runs = []
    for _ in range(2):
        _train_restore(engine, snap)
        losses = torch.stack([engine.forward_backward(b)[0]
                              for b in batches])
        torch.cuda.synchronize()
        runs.append((losses, _train_state(engine),
                     engine.generator.get_state()))
    _train_restore(engine, snap)
    losses, _summary = engine.forward_backward_multi(stacked)
    torch.cuda.synchronize()
    graph = engine._train_graph
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 1, 2)
    assert float(engine.optimizer.param_groups[0]['step']) == 3
    state = _train_state(engine)
    (l_a, s_a, g_a), (l_b, s_b, g_b) = runs
    assert torch.equal(engine.generator.get_state(), g_a)
    for name, got, a, b in [('loss', losses, l_a, l_b)] + [
            (k, state[k], s_a[k], s_b[k]) for k in s_a]:
        if torch.equal(a, b):
            assert torch.equal(got, a), name
        else:
            spread = (b - a).abs().max().item()
            assert (got - a).abs().max().item() <= 4 * spread, name


@pytest.mark.parametrize('int8', [False, True])
def test_grouped_eval_graph_equals_per_batch_eval(cuda, tmp_path, int8):
    """Grouped eval (``batches_per_dispatch`` 4 over 6 query batches: a
    padded trailing group) replays the eval graph and gives the
    per-batch eval's features, visibility and pixel accuracy bit for
    bit, float and int8; a train step re-keys the graph."""
    opts = ['test.batch_size', '8', 'test.batches_per_dispatch', '4']
    if int8:
        opts += ['test.int8', 'True']
    engine = _graph_engine(tmp_path, *opts)
    loader = engine.datamanager.test_loader['synthetic']['query']
    assert len(loader) == 6
    grouped = engine.feature_extraction(loader)
    graph = engine._eval_graph
    # batch 1 eager, batch 2 captured and replayed, batches 3-6 replayed
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 1, 5)
    engine.config.test.batches_per_dispatch = 1
    single = engine.feature_extraction(loader)
    torch.cuda.synchronize()
    assert torch.equal(grouped[0], single[0])
    assert torch.equal(grouped[1], single[1])
    assert grouped[4] == single[4]
    engine.config.test.batches_per_dispatch = 4
    engine.forward_backward(next(iter(engine.datamanager.train_loader)))
    engine.feature_extraction(loader)
    assert graph.eager_steps == 2 and graph.captures == 2
    torch.cuda.synchronize()
