"""A tiny copy of the ``train.osnet_x1_0`` cell for the CPU tests: the
tiny checkout of ``tiny.py`` plus a configuration ``tiny_osnet``
(``osnet_x0_25``'s widths at 64x32, float32, 50 classes) and a cell
``train_softmax.tiny`` (8 identities of one crop a batch, groups of 2
steps, a pool of 2 groups) with the real cell's limits, added as new
files and new ``BENCHMARK.json`` entries only."""
import json
import os

from benchmark import core
from benchmark.tests.tiny import tiny_root

__all__ = ['tiny_osnet_root', 'tiny_osnet_cell', 'REAL', 'CELL']

REAL = 'train.osnet_x1_0'
CELL = 'train_softmax.tiny'


def tiny_osnet_root(tmp):
    root = tiny_root(tmp)
    conf = json.load(open(os.path.join(core.ROOT, 'benchmark', 'configs',
                                       'osnet_x1_0.json')))
    conf['name'] = 'tiny_osnet'
    conf['model'].update(name='osnet_x0_25', height=64, width=32,
                         num_classes=50, channels=[16, 64, 96, 128],
                         compute_dtype='float32')
    w = json.load(open(os.path.join(core.ROOT, 'benchmark', 'workloads',
                                    REAL + '.json')))
    w.update(name=CELL, config='tiny_osnet', ids=8, instances=1,
             steps_per_dispatch=2, pool_groups=2)
    for name, data in (('configs/tiny_osnet.json', conf),
                       ('workloads/{}.json'.format(CELL), w)):
        with open(os.path.join(root, 'benchmark', name), 'w') as f:
            json.dump(data, f)
    bench = core.load_benchmark(root)
    bench['configs'].append({'name': 'tiny_osnet', 'source': 'test',
                             'file': 'benchmark/configs/tiny_osnet.json',
                             'reduced': [], 'why': 'CPU tests'})
    bench['workloads'].append({'name': CELL, 'config': 'tiny_osnet',
                               'traffic': 'train_softmax', 'chips': 1,
                               'why': 'CPU tests'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if REAL in m.get('workloads', ()):
            m['workloads'].append(CELL)
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    return root


def tiny_osnet_cell(root):
    return core.Cell(core.load_benchmark(root), CELL, root)
