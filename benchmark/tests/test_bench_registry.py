"""The harness finds a configuration, a cell and a per-layer metric that
are added as new files and new ``BENCHMARK.json`` entries only, a second
model (not BPBReID) with its own plain reference and traffic kind
included, and ``BENCHMARK.json`` keeps to the shape the harness reads."""
import filecmp
import json
import os
import types

import pytest

from benchmark import calibrate, core, trace
from benchmark.reference import reference_of
from benchmark.tests.tiny import tiny_cell, tiny_root
from benchmark.weights import make_weights

NEW_METRIC = '''"""steps_traced.train: the steps of the profiled stretch."""


def read(ctx):
    return None if ctx.traced is None else float(ctx.traced.steps)
'''


def test_new_files_are_found_and_run(tmp_path):
    root = tiny_root(tmp_path, ('steps_traced.train', NEW_METRIC))
    cell = tiny_cell(root, 'train')
    assert cell.config['model']['backbone'] == 'resnet18'
    assert cell.kind == 'train'
    assert 'steps_traced.train' in [m['name'] for m in cell.per_layer]
    res = core.run_cell(cell, 2 ** 31 + 7, 0.5, 1, 'cpu')
    assert res['metrics']['steps_traced.train']['value'] == 2.0
    assert res['correct'] is True, res['checks']


def test_every_cell_names_its_files():
    bench = core.load_benchmark()
    for w in bench['workloads']:
        cell = core.Cell(bench, w['name'])
        assert cell.workload['name'] == w['name']
        assert os.path.exists(os.path.join(
            core.ROOT, 'benchmark', 'traffic', cell.kind + '.py'))
        assert cell.workload['limits'], w['name']
    for m in bench['per_layer']:
        assert os.path.exists(os.path.join(core.ROOT, 'benchmark', 'metrics',
                                           m['name'] + '.py')), m['name']
        assert hasattr(core.load_reader(m['name']), 'read')


def test_benchmark_json_keys():
    bench = core.load_benchmark()
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    names = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(names) == len(set(names))
    assert 'setup_s' in names
    e2e = {m['name'] for m in bench['end_to_end']}
    assert all(m['moves'] in e2e for m in bench['per_layer'])
    with open(os.path.join(core.ROOT, 'BENCHMARK.json')) as f:
        assert len(f.read()) < 64 * 1024
    assert json.dumps(bench)


# a second model, written into the tiny checkout as new files only
REFERENCE = '''"""A small global-embedding classifier: a strided stem, one
residual block (a depthwise 3x3 convolution, then a pointwise one), global
average pooling, a BN neck and a linear head."""
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import BN, Conv, Linear


class Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dw = Conv(c, c, 3, 1, 1, groups=c)
        self.dw_bn = BN(c)
        self.pw = Conv(c, c, 1)
        self.out_bn = BN(c)

    def forward(self, x):
        y = F.relu(self.dw_bn(self.dw(x)))
        return F.relu(x + self.out_bn(self.pw(y)))


class Net(nn.Module):
    def __init__(self, c, classes):
        super().__init__()
        self.stem = Conv(3, c, 3, 2, 1)
        self.stem_bn = BN(c)
        self.block = Block(c)
        self.neck = BN(c, bias=False)
        self.head = Linear(c, classes, bias=False)

    def forward(self, x):
        f = self.block(F.relu(self.stem_bn(self.stem(x))))
        return {'logits': self.head(self.neck(f.mean(dim=(2, 3))))}


def build(config, device=None):
    m = config['model']
    with torch.device(device or 'cpu'):
        return Net(m['channels'], m['num_classes'])


def state_shapes(config):
    return {k: tuple(v.shape)
            for k, v in build(config, 'meta').state_dict().items()}


def counting_loss(config, out, n, device):
    return F.cross_entropy(out['logits'],
                           torch.zeros(n, dtype=torch.int64, device=device))


def ends_residual(name, shapes):
    return name == 'block.out_bn.weight'
'''

TRAFFIC = '''"""Traffic kind ``softmax``: trains the configuration's plain reference
itself, as a stand-in program, with a softmax cross entropy and SGD on
batches of ``ids`` x ``instances`` seeded images, back to back. The check
takes the first step's loss again from the seeded weights."""
import time

import torch
import torch.nn.functional as F

from benchmark import compare
from benchmark.reference import reference_of
from benchmark.reference.layers import precision
from benchmark.weights import make_weights

TRAINS = True


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.workload = ctx.cell.config, ctx.cell.workload
        self.ref = reference_of(self.config, ctx.cell.root)
        self.steps = 0

    def _loss(self, model, i):
        i %= len(self.images)
        return F.cross_entropy(model(self.images[i])['logits'], self.pids[i])

    def _step(self, i):
        loss = self._loss(self.model, i)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def setup(self):
        m, w, dev = self.config['model'], self.workload, self.ctx.device
        n = w['ids'] * w['instances']
        g = torch.Generator(device=dev).manual_seed(self.ctx.seed + 1)
        self.images = torch.randn(w['pool_batches'], n, 3, m['height'],
                                  m['width'], generator=g, device=dev)
        self.pids = torch.randint(0, m['num_classes'],
                                  (w['pool_batches'], n), generator=g,
                                  device=dev)
        self.weights = make_weights(self.ref.state_shapes(self.config),
                                    self.ctx.seed, dev, self.ref)
        self.model = self.ref.build(self.config, dev)
        self.model.load_state_dict(self.weights, strict=True)
        self.opt = torch.optim.SGD(self.model.parameters(),
                                   lr=self.config['optim']['lr'])
        self.first_loss = self._step(0)

    def window(self, seconds):
        n, steps = self.images.shape[1], 0
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < seconds:
            steps += 1
            self._step(steps)
        dt = time.perf_counter() - t0
        return {'attempted': steps, 'steps': steps, 'images': steps * n,
                'seconds': dt, 'metrics': {'train_images_per_s':
                                           steps * n / dt}}

    def traced(self):
        from benchmark.trace import profile
        return profile(lambda: [self._step(i) for i in range(2)], 2,
                       self.ctx.device)

    def release(self):
        self.model = self.opt = None

    def reference_loss(self, mode):
        with precision(mode):
            model = self.ref.build(self.config, self.ctx.device)
            model.load_state_dict(self.weights, strict=True)
            return float(self._loss(model, 0).detach())

    def check(self):
        gap = compare.relative_gap(self.first_loss, self.reference_loss('f32'))
        return {'loss_step1': compare.check(
            gap, self.workload['limits']['loss_step1'])}


def calibration_readings(ctx_for, seed, controls, seconds):
    tr = ctx_for(seed)
    tr.setup()
    tr.release()
    ref = tr.reference_loss('f32')
    rows = [('sound', {'loss_step1': compare.relative_gap(tr.first_loss,
                                                          ref)}, {})]
    if controls:
        rows.append(('control', {'loss_step1': compare.relative_gap(
            tr.reference_loss('fp8'), ref)}, {'precision': 'fp8'}))
    return rows
'''

CONFIG = {'name': 'dwnet', 'reference': 'dwnet',
          'model': {'height': 32, 'width': 16, 'channels': 6,
                    'num_classes': 10, 'compute_dtype': 'float32'},
          'optim': {'lr': 0.01}}
CELL = 'softmax.dwnet'
WORKLOAD = {'name': CELL, 'config': 'dwnet', 'traffic': 'softmax', 'ids': 2,
            'instances': 4, 'pool_batches': 2,
            'limits': {'loss_step1': 1e-5}}
# forward FLOPs an image, 2 per multiply-add: the stem (3 -> 6, 3x3,
# stride 2: a 16x8 map), the depthwise 3x3 and the pointwise 6 -> 6 at
# 16x8, the head 6 -> 10
FLOPS_BY_HAND = (2 * 16 * 8 * 6 * 3 * 9 + 2 * 16 * 8 * 6 * 9
                 + 2 * 16 * 8 * 6 * 6 + 2 * 6 * 10)


def _second_model(tmp_path):
    """The tiny checkout with the second model added as new files and new
    ``BENCHMARK.json`` entries only."""
    root = tiny_root(tmp_path)
    files = {'reference/dwnet.py': REFERENCE, 'traffic/softmax.py': TRAFFIC,
             'configs/dwnet.json': json.dumps(CONFIG),
             'workloads/{}.json'.format(CELL): json.dumps(WORKLOAD)}
    for name, text in files.items():
        path = os.path.join(root, 'benchmark', name)
        assert not os.path.exists(path)
        with open(path, 'w') as f:
            f.write(text)
    bench = core.load_benchmark(root)
    bench['configs'].append({'name': 'dwnet', 'source': 'test',
                             'file': 'benchmark/configs/dwnet.json',
                             'reduced': [], 'why': 'CPU tests'})
    bench['workloads'].append({'name': CELL, 'config': 'dwnet',
                               'traffic': 'softmax', 'chips': 1,
                               'why': 'CPU tests'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if m['name'] in ('train_images_per_s', 'mfu.train',
                         'bn_roofline.train'):
            m['workloads'].append(CELL)
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    # every file the benchmark had is as it was
    for folder, _, names in os.walk(os.path.join(core.ROOT, 'benchmark')):
        if '__pycache__' in folder or '_cache' in folder:
            continue
        for name in names:
            ours = os.path.join(folder, name)
            theirs = os.path.join(root, os.path.relpath(ours, core.ROOT))
            assert filecmp.cmp(ours, theirs, shallow=False), theirs
    return root


def test_a_second_model_needs_only_new_files(tmp_path, monkeypatch):
    root = _second_model(tmp_path)
    cell = core.Cell(core.load_benchmark(root), CELL, root)
    assert [m['name'] for m in cell.per_layer] == ['bn_roofline.train',
                                                   'mfu.train']
    # CPU ops stand in for the device's kernels, so that
    # bn_roofline.train finds batch norms to time
    monkeypatch.setattr(trace, 'DEVICE_CATS',
                        trace.DEVICE_CATS + ('cpu_op',))
    seen = {}
    load_reader = core.load_reader

    def spy(name, where=core.ROOT):
        reader = load_reader(name, where)

        def read(ctx):
            seen[name] = ctx
            return reader.read(ctx)
        return types.SimpleNamespace(read=read)
    monkeypatch.setattr(core, 'load_reader', spy)
    res = core.run_cell(cell, 2 ** 31 + 11, 0.3, 1, 'cpu')
    assert res['correct'] is True, res['checks']

    ctx = seen['mfu.train']
    counts, w = ctx.counts, ctx.window
    assert counts.batch == 8
    assert counts.forward_flops_per_image == FLOPS_BY_HAND
    assert res['metrics']['mfu.train']['value'] == pytest.approx(
        100.0 * FLOPS_BY_HAND * 3 * w['images'] / w['seconds']
        / ctx.peaks['bf16_dense_flops'])

    fmap = (8, 6, 16, 8)
    assert counts.bns == [('stem_bn', fmap, True), ('block.dw_bn', fmap, True),
                          ('block.out_bn', fmap, True),
                          ('neck', (8, 6), True)]
    assert counts.feature_map is None
    # float32: forward 2 x 768 x 4 bytes a map + 4 x 6 floats, backward
    # 3 x 768 x 4 + 2 x 6 floats; the neck's [8, 6] alike
    per_map = 2 * 6144 * 4 + 4 * 6 * 4 + 3 * 6144 * 4 + 2 * 6 * 4
    neck = 2 * 48 * 4 + 4 * 6 * 4 + 3 * 48 * 4 + 2 * 6 * 4
    bn = load_reader('bn_roofline.train', root)
    assert bn.bound_bytes(counts.bns, 4) == 3 * per_map + neck
    t = seen['bn_roofline.train'].traced
    assert res['metrics']['bn_roofline.train']['value'] == pytest.approx(
        100.0 * (3 * per_map + neck) / ctx.peaks['hbm_bytes_per_s']
        / (t.device_us(bn.BN_KERNELS) / t.steps / 1e6))

    # the seeded weights end the residual branch by the reference's rule
    ref = reference_of(cell.config, root)
    shapes = ref.state_shapes(cell.config)
    scaled = make_weights(shapes, 5, 'cpu', ref)
    plain = make_weights(shapes, 5, 'cpu')
    assert scaled['block.out_bn.weight'].abs().max() < 0.2
    assert plain['block.out_bn.weight'].abs().min() > 0.5
    assert scaled['block.dw.weight'].equal(plain['block.dw.weight'])


def test_a_configuration_names_its_reference(tmp_path):
    from benchmark.reference import model
    assert reference_of({}) is model
    assert reference_of({'reference': 'model'}) is model
    with pytest.raises(FileNotFoundError, match='nothing_here'):
        reference_of({'reference': 'nothing_here'})
    with pytest.raises(ValueError):
        reference_of({'reference': '../model'})
    root = _second_model(tmp_path)
    ref = reference_of(CONFIG, root)
    assert ref is reference_of(CONFIG, root)
    assert not hasattr(ref, 'feature_map')


def test_calibrate_reaches_a_second_kind(tmp_path):
    root = _second_model(tmp_path)
    assert calibrate.main(['--workload', CELL, '--seeds', '2',
                           '--controls', '1', '--device', 'cpu'],
                          root=root) == 0
    with open(os.path.join(root, 'chiprun_out',
                           'calibrate_{}.jsonl'.format(CELL))) as f:
        rows = [json.loads(line) for line in f]
    assert [r['what'] for r in rows] == ['sound', 'control', 'sound']
    limit = WORKLOAD['limits']['loss_step1']
    for r in rows:
        assert (r['readings']['loss_step1'] > limit) == \
            (r['what'] == 'control'), r
