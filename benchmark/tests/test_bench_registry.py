"""The harness finds a configuration, a cell and a per-layer metric that
are added as new files and new ``BENCHMARK.json`` entries only, and
``BENCHMARK.json`` keeps to the shape the harness reads."""
import json
import os

from benchmark import core
from benchmark.tests.tiny import tiny_cell, tiny_root

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
