"""The six readers of the program's spans (``benchmark/spans.py``,
``benchmark/metrics/``) on a fabricated trace worked out by hand, None
on a trace without the program's spans (as on a commit that records
none), and a tiny ``--trace 1`` run of each traffic kind on the CPU,
where the engine's spans are recorded and the CUDA graph's are not."""
import types

import pytest

from benchmark import core
from benchmark.tests.tiny import tiny_cell, tiny_root
from benchmark.trace import Trace

READERS = ['input_copy_ms.train', 'graph_host_ms.train',
           'graph_host_ms.embed', 'prefetch_wait_ms.embed',
           'graph_rebuilds.train', 'graph_rebuilds.embed']


def _event(name, ts, dur, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def _trace(steps=2):
    """Two steps: an eager graph call and a replay, each 1 ms with a
    graph launch of 0.1 ms inside the replay (and one outside every
    call), a 0.3 + 0.5 ms copy of the inputs and a 0.25 + 0.75 ms wait
    for the prefetch."""
    events = [
        _event('engine.train_inputs', 0.0, 300.0),
        _event('aten::to', 10.0, 200.0, 'cpu_op'),
        _event('engine.train_inputs', 5000.0, 500.0),
        _event('prefetch.wait', 400.0, 250.0),
        _event('prefetch.wait', 6000.0, 750.0),
        _event('graph.step', 1000.0, 1000.0),
        _event('graph.eager', 1100.0, 800.0),
        _event('graph.step', 3000.0, 1000.0),
        _event('graph.replay', 3100.0, 500.0),
        _event('cudaGraphLaunch', 3200.0, 100.0, 'cuda_runtime'),
        _event('cudaGraphLaunch', 4500.0, 40.0, 'cuda_runtime'),
        _event('cudaLaunchKernel', 3400.0, 10.0, 'cuda_runtime'),
        _event('k', 3200.0, 900.0, 'kernel'),
    ]
    return Trace(events, steps, 0.01)


def _read(name, trace):
    return core.load_reader(name).read(types.SimpleNamespace(traced=trace))


@pytest.mark.parametrize('name,value', [
    ('input_copy_ms.train', 0.4),       # (300 + 500) us / 2 steps
    ('prefetch_wait_ms.embed', 0.5),    # (250 + 750) us / 2
    ('graph_host_ms.train', 0.95),      # (1000 + 1000 - 100) us / 2
    ('graph_host_ms.embed', 0.95),
    ('graph_rebuilds.train', 0.5),      # one eager call in 2 steps
    ('graph_rebuilds.embed', 0.5)])
def test_reader_by_hand(name, value):
    assert _read(name, _trace()) == pytest.approx(value)


@pytest.mark.parametrize('name', READERS)
def test_reader_without_its_spans(name):
    bare = Trace([_event('aten::to', 0.0, 200.0, 'cpu_op'),
                  _event('cudaGraphLaunch', 10.0, 5.0, 'cuda_runtime'),
                  _event('k', 0.0, 900.0, 'kernel')], 2, 0.01)
    assert _read(name, bare) is None
    assert _read(name, None) is None
    assert _read(name, _trace(steps=0)) is None


def test_rebuilds_read_zero_when_every_call_replays():
    replays = Trace([_event('graph.step', 0.0, 10.0),
                     _event('graph.replay', 1.0, 5.0)], 1, 0.01)
    assert _read('graph_rebuilds.train', replays) == 0.0


@pytest.mark.parametrize('kind,read,silent', [
    ('train', 'input_copy_ms.train',
     ('graph_host_ms.train', 'graph_rebuilds.train')),
    ('embed', 'prefetch_wait_ms.embed',
     ('graph_host_ms.embed', 'graph_rebuilds.embed'))])
def test_tiny_traced_run_reads_the_engine_spans(tmp_path, kind, read, silent):
    root = tiny_root(tmp_path)
    res = core.run_cell(tiny_cell(root, kind), 2 ** 31 + 11, 0.3, 1, 'cpu')
    assert res['correct'] is True, res['checks']
    assert res['metrics'][read]['value'] > 0
    # the CPU runs no CUDA graph: its metrics are left out of the line
    for name in silent:
        assert name not in res['metrics']
