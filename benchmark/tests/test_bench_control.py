"""The control of each traffic kind, at a size a test run holds: the
lower precision put in the program's place fails each real cell's limits
on at least one number. ``train``: the reference with float8 products;
``embed``: the program's own int8 path. ``benchmark/calibrate.py`` reads
the same controls on the card at the cells' own sizes, through each
kind's ``calibration_readings``, and refuses a kind without them."""
import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import calibrate, core
from benchmark.reference import layers
from benchmark.tests.tiny import tiny_cell, tiny_root

SEED = 3000000041


def _readings(tmp_path, kind, real):
    cell = tiny_cell(tiny_root(tmp_path, real={kind: real}), kind)
    traffic = core.load_traffic(kind)

    def ctx_for(seed):
        return traffic.Traffic(core.Context(cell, seed, 'cpu'))
    rows = traffic.calibration_readings(ctx_for, SEED, True, 0.3)
    return cell.workload['limits'], {what: r for what, r, _ in rows}


def _fails(limits, readings):
    return [n for n, lim in limits.items() if readings[n] > lim]


@pytest.mark.parametrize('real', ['train.bpbreid_hrnet32',
                                  'train.bpbreid_resnet50'])
def test_train_control_fails(tmp_path, real):
    limits, rows = _readings(tmp_path, 'train', real)
    assert not _fails(limits, rows['sound'])
    assert _fails(limits, rows['control'])
    assert _fails(limits, rows['fault_half_batch'])


@pytest.mark.parametrize('real', ['embed.bpbreid_hrnet32',
                                  'embed.bpbreid_resnet50'])
def test_embed_control_fails(tmp_path, real):
    limits, rows = _readings(tmp_path, 'embed', real)
    assert not _fails(limits, rows['sound'])
    assert _fails(limits, rows['control'])


def test_calibrate_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert calibrate.main(['--workload', 'train.bpbreid_hrnet32']) == 2


def test_calibrate_refuses_a_kind_without_readings(tmp_path, capsys):
    root = tiny_root(tmp_path)
    with open(os.path.join(root, 'benchmark', 'traffic', 'bare.py'),
              'w') as f:
        f.write('"""A kind with no calibration_readings."""\nTRAINS = '
                'False\n')
    with open(os.path.join(root, 'benchmark', 'workloads',
                           'bare.tiny.json'), 'w') as f:
        json.dump({'name': 'bare.tiny', 'config': 'tiny',
                   'traffic': 'bare'}, f)
    bench = core.load_benchmark(root)
    bench['workloads'].append({'name': 'bare.tiny', 'config': 'tiny',
                               'traffic': 'bare', 'chips': 1,
                               'why': 'CPU tests'})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    assert calibrate.main(['--workload', 'bare.tiny', '--device', 'cpu'],
                          root=root) == 2
    assert "'bare'" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(root, 'chiprun_out'))


def test_depthwise_conv_takes_the_control():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 6, 5, generator=g, requires_grad=True)
    conv = layers.Conv(8, 8, 3, 1, 1, groups=8)
    conv.weight.data = torch.randn(8, 1, 3, 3, generator=g)
    with layers.precision('f32'):
        plain = conv(x)
    assert torch.equal(plain, F.conv2d(x, conv.weight, None, 1, 1, 1, 8))
    with layers.precision('fp8'):
        low = conv(x)
        low.sum().backward()
    rounded = F.conv2d(layers._quantize(x.detach(), 'e4m3'),
                       layers._quantize(conv.weight.detach(), 'e4m3'),
                       None, 1, 1, 1, 8)
    assert torch.equal(low.detach(), rounded)
    assert not torch.equal(low.detach(), plain.detach())
    assert conv.weight.grad.shape == (8, 1, 3, 3)
