"""A tiny copy of the benchmark for the CPU tests: a checkout-like
directory holding ``BENCHMARK.json`` and the benchmark's files plus a
cell of each traffic kind on a small configuration (ResNet-18 at 64x32,
float32, 2 identities x 4 crops), added as new files only. The tiny
cells take the limits of the real cells of their kind."""
import json
import os
import shutil

import torch

from benchmark import core

__all__ = ['tiny_root', 'tiny_cell', 'REAL']

REAL = {'train': 'train.bpbreid_hrnet32', 'embed': 'embed.bpbreid_hrnet32'}


def tiny_root(tmp, extra_metric=None, real=None):
    """Write the tiny checkout under ``tmp``; returns its path. With
    ``extra_metric`` ``(name, source)``, also a per-layer metric read by a
    new reader file. ``real`` (kind -> cell) names the real cells whose
    limits the tiny cells take (``REAL`` by default)."""
    real_cells = dict(REAL, **(real or {}))
    torch.set_num_threads(2)
    root = str(tmp)
    shutil.copytree(os.path.join(core.ROOT, 'benchmark'),
                    os.path.join(root, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    bench = core.load_benchmark()
    conf = json.load(open(os.path.join(core.ROOT, 'benchmark', 'configs',
                                       'bpbreid_hrnet32.json')))
    conf['name'] = 'tiny'
    conf['model'].update(backbone='resnet18', height=64, width=32,
                         num_classes=50, compute_dtype='float32')
    with open(os.path.join(root, 'benchmark', 'configs', 'tiny.json'),
              'w') as f:
        json.dump(conf, f)
    bench['configs'].append({'name': 'tiny', 'source': 'test',
                             'file': 'benchmark/configs/tiny.json',
                             'reduced': [], 'why': 'CPU tests'})
    for kind, source in real_cells.items():
        w = json.load(open(os.path.join(core.ROOT, 'benchmark', 'workloads',
                                        source + '.json')))
        w.update(name=kind + '.tiny', config='tiny', ids=2, instances=4,
                 pool_groups=2, steps_per_dispatch=2, batches_per_request=2,
                 pool_requests=2)
        port = w.setdefault('port', {})
        port.setdefault('test', {}).update(batches_per_dispatch=2,
                                           batch_size=8)
        with open(os.path.join(root, 'benchmark', 'workloads',
                               kind + '.tiny.json'), 'w') as f:
            json.dump(w, f)
        bench['workloads'].append({'name': kind + '.tiny', 'config': 'tiny',
                                   'traffic': kind, 'chips': 1,
                                   'why': 'CPU tests'})
        for m in bench['end_to_end'] + bench['per_layer']:
            if source in m.get('workloads', ()):
                m['workloads'].append(kind + '.tiny')
    if extra_metric is not None:
        name, source = extra_metric
        with open(os.path.join(root, 'benchmark', 'metrics', name + '.py'),
                  'w') as f:
            f.write(source)
        bench['per_layer'].append({
            'name': name, 'unit': 'steps', 'better': 'higher',
            'source': 'program_counter', 'layer': 'test',
            'moves': 'train_images_per_s', 'workloads': ['train.tiny']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    return root


def tiny_cell(root, kind):
    return core.Cell(core.load_benchmark(root), kind + '.tiny', root)
