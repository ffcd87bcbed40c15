"""The FLOP and byte counts behind ``mfu.*``, ``bn_roofline.*`` and
``k2_roofline.embed``, on shapes worked out by hand, and the counts of
the four cells pinned as the benchmark first computed them (PERF.md
section 3 rounds them), so a change to the harness moves no reading."""
import hashlib
import json
import os
import types

import pytest
import torch

from benchmark import core
from benchmark.counts import model_counts
from benchmark.reference import model as ref_model
from benchmark.reference import reference_of
from benchmark.trace import Trace, union_us
from benchmark.weights import _ends_residual, make_weights

PEAKS = json.load(open(os.path.join(core.ROOT, 'benchmark', 'peaks.json')))


def _ctx(compute='bfloat16', parts=5, **kw):
    cell = types.SimpleNamespace(config={'model': {
        'compute_dtype': compute, 'parts_num': parts}})
    return types.SimpleNamespace(cell=cell, peaks=PEAKS, **kw)


def _trace(kernels, steps, wall=1.0):
    events = [{'ph': 'X', 'cat': 'kernel', 'name': n, 'ts': ts, 'dur': d}
              for n, ts, d in kernels]
    return Trace(events, steps, wall)


def test_bn_bytes_by_hand():
    train = core.load_reader('bn_roofline.train')
    embed = core.load_reader('bn_roofline.embed')
    bns = [('a.bn', (2, 3, 4, 5), True), ('b.bn', (2, 7), False),
           ('pixel_classifier.bn', (2, 3, 4, 5), True)]
    # a: forward 2 x 120 x 2 bytes + 4 x 3 floats, backward 3 x 120 x 2 +
    # 2 x 3 floats; b: forward 2 x 14 x 2 + 4 x 7 floats; the pixel
    # classifier's is left out
    fwd = 2 * 120 * 2 + 4 * 3 * 4 + 2 * 14 * 2 + 4 * 7 * 4
    assert train.bound_bytes(bns, 2) == fwd + 3 * 120 * 2 + 2 * 3 * 4
    assert embed.bound_bytes(bns, 2) == fwd


def test_bn_roofline_share():
    reader = core.load_reader('bn_roofline.embed')
    counts = types.SimpleNamespace(bns=[('x', (1, 1000, 1000), False)])
    nbytes = 2 * 10 ** 6 * 2 + 4 * 1000 * 4
    bound = nbytes / PEAKS['hbm_bytes_per_s']
    trace = _trace([('void ewise_rows_kernel<bf16>', 0.0, bound * 2e6),
                    ('void other_kernel', 0.0, 5.0)], steps=2)
    # two steps, the BN kernel took twice the bound in all: one bound a
    # step, so 100 %
    assert reader.read(_ctx(traced=trace, counts=counts)) == \
        pytest.approx(100.0)
    empty = _trace([('void other_kernel', 0.0, 5.0)], steps=2)
    assert reader.read(_ctx(traced=empty, counts=counts)) is None


def test_k2_bytes_by_hand():
    reader = core.load_reader('k2_roofline.embed')
    counts = types.SimpleNamespace(feature_map=(2, 3, 4, 5))
    # bf16 map 2*3*4*5*2, bf16 logits 2*6*4*5*2, outputs (2*6*3 + 2*2*6)*4
    nbytes = 240 + 480 + (36 + 24) * 4
    bound_us = nbytes / PEAKS['hbm_bytes_per_s'] * 1e6
    trace = _trace([('attention_pool_kernel<__nv_bfloat16, 8>', 0.0,
                     4 * bound_us),
                    ('attention_pool_kernel<__nv_bfloat16, 8>', 10.0,
                     4 * bound_us)], steps=2)
    assert reader.read(_ctx(traced=trace, counts=counts)) == \
        pytest.approx(25.0)


def test_mfu_by_hand():
    train = core.load_reader('mfu.train')
    embed = core.load_reader('mfu.embed')
    counts = types.SimpleNamespace(forward_flops_per_image=1e9)
    window = {'images': 989, 'seconds': 1.0}
    assert embed.read(_ctx(window=window, counts=counts)) == \
        pytest.approx(100.0 * 989e9 / 989e12)
    assert train.read(_ctx(window=window, counts=counts)) == \
        pytest.approx(300.0 * 989e9 / 989e12)


def test_idle_and_launches():
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    trace = _trace([('k', 0.0, 200000.0), ('k', 100000.0, 200000.0)],
                   steps=4, wall=0.5)
    assert trace.busy_s() == pytest.approx(0.3)
    assert core.load_reader('idle_share.train').read(
        _ctx(traced=trace)) == pytest.approx(40.0)
    trace.api = [('cudaLaunchKernel', 0, 1), ('cudaGraphLaunch_v10000', 0, 1),
                 ('cuLaunchKernelEx', 0, 1), ('cudaMemcpyAsync', 0, 1)]
    assert core.load_reader('host_launches.train').read(
        _ctx(traced=trace)) == pytest.approx(0.75)


def _conv_flops(config, n):
    """2 x multiply-adds of every convolution and linear layer, and of the
    three pooling products, by hooks on a CPU forward."""
    model = ref_model.build(config)
    m = config['model']
    with torch.no_grad():
        _, d, h, w = model.backbone_appearance_feature_extractor(
            torch.zeros(1, 3, m['height'], m['width'])).shape
    total = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, ref_model.Conv):
            w = mod.weight
            total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        elif isinstance(mod, ref_model.Linear):
            total[0] += 2 * out.numel() * mod.weight.shape[1]
    for mod in model.modules():
        mod.register_forward_hook(hook)
    with torch.no_grad():
        model.eval()
        model(torch.zeros(n, 3, m['height'], m['width']))
    k = m['parts_num']
    return total[0] + 2 * n * d * h * w * (2 + k)


def test_forward_flops_match_the_layers():
    config = json.load(open(os.path.join(
        core.ROOT, 'benchmark', 'configs', 'bpbreid_resnet50.json')))
    config['model'].update(backbone='resnet18', height=64, width=32)
    counts = model_counts(config, {'traffic': 'embed', 'ids': 2,
                                   'instances': 2})
    assert counts.forward_flops_per_image * 4 == _conv_flops(config, 4)
    assert counts.feature_map == (4, 512, 4, 2)
    train = model_counts(config, {'traffic': 'train', 'ids': 2,
                                  'instances': 2})
    no_grad = {name for name, _, g in train.bns if not g}
    assert 'background_identity_classifier.bn' in no_grad
    assert 'global_identity_classifier.bn' not in no_grad


# the batch norms that no loss term reaches, in both train cells
NO_GRAD = ['background_after_pooling_dim_reduce.layers.1',
           'background_identity_classifier.bn'] + [
    'parts_identity_classifier.{}.bn'.format(i) for i in range(5)]
# cell: (forward FLOPs an image, batch norms, of them with a gradient,
# sha256 of the JSON list [[name, shape, gets a gradient], ...], map)
PINNED = {
    'train.bpbreid_hrnet32': (
        16092924928, 335, 328,
        '5b1640e46e3337829b36d6339f5a31133bb0e33c0421d5d1e59ed161b6cac918',
        (64, 1920, 96, 32)),
    'embed.bpbreid_hrnet32': (
        16092924928, 335, 0,
        'de7bc5944dbbdf13443e90d2db11684a38431a55c5f4dd983f74319e1f34af9f',
        (64, 1920, 96, 32)),
    'train.bpbreid_resnet50': (
        12196809728, 67, 60,
        '9aa85aaab927b37f07f64088b2dc9d8430fbc910a9d152e7b3e3e6c968133640',
        (64, 2048, 24, 8)),
    'embed.bpbreid_resnet50': (
        12196809728, 67, 0,
        '2b9deea65fc7a09a6bacdba3510615f35e829f10af14b2483e396ab6ec31065f',
        (64, 2048, 24, 8)),
}


@pytest.mark.parametrize('name', sorted(PINNED))
def test_cell_counts_are_pinned(name):
    flops, n_bns, n_grad, digest, fmap = PINNED[name]
    cell = core.find_cell(name)
    counts = model_counts(cell.config, cell.workload)
    assert counts.batch == 64
    assert counts.forward_flops_per_image == flops
    assert len(counts.bns) == n_bns
    assert sum(g for _, _, g in counts.bns) == n_grad
    if n_grad:
        assert [n for n, _, g in counts.bns if not g] == NO_GRAD
    assert counts.bns[0] == ('backbone_appearance_feature_extractor.bn1',
                             (64, 64, 192, 64), n_grad > 0)
    listed = json.dumps([[n, list(s), g] for n, s, g in counts.bns])
    assert hashlib.sha256(listed.encode()).hexdigest() == digest
    assert counts.feature_map == fmap


# config: (residual ends among the scales, sha256 of their sorted names)
RESIDUAL_ENDS = {
    'bpbreid_hrnet32': (
        112,
        '0ff87741f938fe531b120598df892e801ddf9b25ad116d4eb60e34b8cb47f951'),
    'bpbreid_resnet50': (
        16,
        'c8b93aef9f6cb3b13d675f6c9adaa90e1266e8212062d9b16d49f0136362c8f6'),
}


@pytest.mark.parametrize('name', sorted(RESIDUAL_ENDS))
def test_residual_ends_are_pinned(name):
    """The BPBReID reference gives no ``ends_residual``, so the weights
    take the default rule, and scale the same scales as before."""
    config = json.load(open(os.path.join(core.ROOT, 'benchmark', 'configs',
                                         name + '.json')))
    ref = reference_of(config)
    assert ref is ref_model and not hasattr(ref, 'ends_residual')
    shapes = ref.state_shapes(config)
    ends = sorted(n for n in shapes
                  if n.endswith('.weight') and _ends_residual(n, shapes))
    count, digest = RESIDUAL_ENDS[name]
    assert len(ends) == count
    assert hashlib.sha256(json.dumps(ends).encode()).hexdigest() == digest
    small = {n: (4,) for n in ends[:2]}
    small['other.bn.weight'] = (4,)
    w = make_weights(small, 5, 'cpu', ref)
    plain = make_weights(small, 5, 'cpu')
    for n in small:
        assert torch.equal(w[n], plain[n])
    assert w[ends[0]].abs().max() < 0.2 < w['other.bn.weight'].abs().min()
