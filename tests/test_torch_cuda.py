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
