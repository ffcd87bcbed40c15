"""The harness: finds a cell's configuration, traffic kind and metric
readers by the names in ``BENCHMARK.json``, runs the cell once and prints
its result line.

A run: set-up (the traffic kind's ``setup``), the measured window
(``window``), with ``--trace 1`` a profiled stretch after the window
(``traced``), the device's peak memory, the program's state freed
(``release``), then the comparison with the plain reference that decides
``correct`` (``check``). With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read
by its own module ``benchmark/metrics/<name>.py``.

A traffic kind is the module ``benchmark/traffic/<kind>.py``. It gives
``TRAINS`` (whether its step trains: the counts then take the train-mode
forward and its backward), the class ``Traffic(ctx)`` with ``setup``,
``window(seconds)``, ``traced``, ``release`` and ``check``, and, for
``benchmark/calibrate.py``, ``calibration_readings(ctx_for, seed,
controls, seconds)``. Its model comes from the configuration's plain
reference (``benchmark/reference/__init__.py``).
"""
import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import zlib

__all__ = ['ROOT', 'load_benchmark', 'find_cell', 'load_module',
           'load_traffic', 'load_reader', 'main', 'percentile',
           'process_age_s', 'forbidden_modules', 'Cell']

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, 'benchmark')
# what no process of the benchmark may load: JAX and the JAX package
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'bpbreid_tpu')


def load_benchmark(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell of ``BENCHMARK.json``: its entry, its workload file
    (``benchmark/workloads/<name>.json``), its configuration file and the
    metrics it reports."""

    def __init__(self, bench, name, root=ROOT):
        entries = {w['name']: w for w in bench['workloads']}
        if name not in entries:
            raise KeyError('no workload {!r} in BENCHMARK.json (known: {})'
                           .format(name, ', '.join(sorted(entries))))
        self.entry = entries[name]
        self.name, self.root = name, root
        self.workload = _read_json(os.path.join(
            root, 'benchmark', 'workloads', name + '.json'))
        configs = {c['name']: c for c in bench['configs']}
        for key in ('config', 'traffic'):
            if self.workload[key] != self.entry[key]:
                raise ValueError('{}: {} is {!r} in BENCHMARK.json and {!r} '
                                 'in its workload file'.format(
                                     name, key, self.entry[key],
                                     self.workload[key]))
        self.config = _read_json(os.path.join(
            root, configs[self.entry['config']]['file']))
        self.kind = self.workload['traffic']
        self.chips = int(self.entry['chips'])
        self.end_to_end = [m for m in bench['end_to_end'] if self._has(m)]
        self.per_layer = [m for m in bench['per_layer'] if self._has(m)]

    def _has(self, metric):
        return 'workloads' not in metric or self.name in metric['workloads']


def find_cell(name, root=ROOT):
    return Cell(load_benchmark(root), name, root)


def load_module(sub, name, root=ROOT):
    """The module ``benchmark/<sub>/<name>.py``: the benchmark package's
    own where it has one, else the file in the checkout at ``root`` (a kind
    or a reference that a cell adds as a new file), loaded once."""
    if os.path.exists(os.path.join(BENCH_DIR, sub, name + '.py')):
        return importlib.import_module('benchmark.{}.{}'.format(sub, name))
    path = os.path.realpath(os.path.join(root, 'benchmark', sub,
                                         name + '.py'))
    if not os.path.exists(path):
        raise FileNotFoundError('no benchmark/{}/{}.py in {}'.format(
            sub, name, root))
    key = 'benchmark_{}_{}_{:08x}'.format(sub, name,
                                          zlib.crc32(path.encode()))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def load_traffic(kind, root=ROOT):
    """The traffic kind's module ``benchmark/traffic/<kind>.py``."""
    return load_module('traffic', kind, root)


def load_reader(metric_name, root=ROOT):
    """The reader module ``benchmark/metrics/<name>.py`` of a per-layer
    metric (the name may hold dots)."""
    path = os.path.join(root, 'benchmark', 'metrics', metric_name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + metric_name.replace('.', '_').replace('-', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` % of the values at or below it."""
    if not values:
        raise ValueError('no values')
    s = sorted(values)
    rank = max(1, -(-len(s) * q // 100))
    return s[int(rank) - 1]


def process_age_s():
    """Seconds since this process started, from ``/proc`` (the clock
    ticks of its start against the system's uptime)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    start_ticks = int(fields[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is JAX's or the JAX
    package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split('.')[0] in FORBIDDEN)


def power_limit():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


class Context:
    """What the traffic kinds and the metric readers share in one run."""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.window = {}         # the window's counts and seconds
        self.traced = None       # trace.Trace of the profiled stretch
        self.counts = None       # counts.ModelCounts of the plain model
        self.peaks = _read_json(os.path.join(BENCH_DIR, 'peaks.json'))


def _parse(argv):
    ap = argparse.ArgumentParser(description='Run one benchmark cell once.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed, seconds, trace, device, t_setup0=0.0):
    """One run of ``cell``; returns the result dict (without printing).
    ``t_setup0``: seconds of set-up already spent before this call."""
    import torch
    traffic = load_traffic(cell.kind, cell.root).Traffic(
        Context(cell, seed, device))
    ctx = traffic.ctx
    t0 = time.perf_counter()
    traffic.setup()
    setup_s = t_setup0 + time.perf_counter() - t0
    ctx.window = traffic.window(seconds)
    if trace:
        ctx.traced = traffic.traced()
    cuda = torch.device(device).type == 'cuda'
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traffic.release()
    checks = traffic.check()
    # the compared numbers beyond their limits (an operation of the window
    # that fails ends the run)
    failed = sum(c['value'] > c['limit'] for c in checks.values())
    correct = bool(checks) and not failed
    metrics = {}
    if trace:
        from benchmark.counts import model_counts
        ctx.counts = model_counts(cell.config, cell.workload, cell.root)
        for m in cell.per_layer:
            value = load_reader(m['name'], cell.root).read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = dict(ctx.window['metrics'], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': cell.chips, 'memory_peak_bytes': peak}
    if cuda:
        dev['power_limit'] = power_limit()
    result = {'correct': correct, 'attempted': ctx.window['attempted'],
              'failed': failed, 'metrics': metrics, 'device': dev}
    if trace:
        dev['busy_s'] = ctx.traced.busy_s()
        dev['window_s'] = ctx.traced.wall_s
        result['breakdown'] = ctx.traced.breakdown()
    result['checks'] = checks
    return result


def main(argv):
    """The command line: exits 0 after printing the result line, else
    non-zero with nothing on standard output."""
    args = _parse(argv)
    age = process_age_s()
    t_main = time.perf_counter()
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print('benchmark: the cell needs {} CUDA device(s); {} available'
              .format(cell.chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    pre = age + (time.perf_counter() - t_main)
    result = run_cell(cell, args.seed, args.seconds, args.trace, 'cuda:0',
                      t_setup0=pre)
    found = forbidden_modules()
    if found:
        print('benchmark: forbidden modules loaded: ' + ', '.join(found),
              file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print('check {}: {:.6g} (limit {:.6g}) {}'.format(
            name, c['value'], c['limit'],
            'ok' if c['value'] <= c['limit'] else 'FAILED'), file=sys.stderr)
    print('correct: {}'.format(result['correct']), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
