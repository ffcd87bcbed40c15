"""The port's spans (``bpbreid_tpu_torch/utils/tracing.py``): unprofiled,
``span`` never enters ``record_function``; profiled, each span is a
``user_annotation`` event of the profiler's Chrome trace on the wall
clock, and a tiny engine's train group and feature extraction leave the
spans the benchmark's readers take (``benchmark/metrics/``). The CUDA
graph's spans (``engine/graphs.py``) are counted against its counters on
the card (marker ``cuda``). ``Engine.run`` ends with the graphs' counts.
No module here imports JAX: the card's test run imports this file."""
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.engine import Engine
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.tools import profile_summary
from bpbreid_tpu_torch.utils import tracing
from bpbreid_tpu_torch.utils.writer import ProfilerTrace

# as tests/torch_port_helpers.py limit_torch_threads, which imports JAX
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')


def _spans(trace_dir):
    """``{name: [(start_us, end_us)]}`` of the trace's spans."""
    with open(os.path.join(trace_dir, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    out = {}
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == 'user_annotation':
            out.setdefault(e['name'], []).append(
                (float(e['ts']), float(e['ts']) + float(e['dur'])))
    return out


def _inside(inner, outer):
    return all(any(s >= os_ and e <= oe for os_, oe in outer)
               for s, e in inner)


def _counting(monkeypatch):
    entered = []
    real = tracing.record_function

    def counted(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(tracing, 'record_function', counted)
    return entered


def test_span_off_enters_no_record_function(monkeypatch):
    entered = _counting(monkeypatch)
    first, second = tracing.span('a'), tracing.span('b')
    assert first is second
    with first:
        pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span('c'):
            pass
    assert entered == ['c']


def test_span_is_a_trace_event_on_the_wall_clock(tmp_path):
    with ProfilerTrace(str(tmp_path)):
        t0 = time.time_ns()
        with tracing.span('outer'):
            with tracing.span('inner'):
                torch.ones(4).sum()
        t1 = time.time_ns()
    with open(tmp_path / 'trace.json') as f:
        trace = json.load(f)
    base = trace['baseTimeNanoseconds']
    spans = _spans(str(tmp_path))
    assert _inside(spans['inner'], spans['outer'])
    (start, end), = spans['outer']
    # microseconds of the trace plus its base are time.time_ns()
    assert t0 - 1e5 <= start * 1e3 + base <= end * 1e3 + base <= t1 + 1e5
    assert ('outer', 1) in [(n, c) for n, _ns, c in
                            profile_summary.span_totals(
                                str(tmp_path / 'trace.json'))]


@pytest.fixture(scope='module')
def engine(tmp_path_factory):
    """The smoke config's BPBReID (resnet18 at 64x32, float32) on the
    CPU, eval batches in groups of 2."""
    clear_dataset_cache()
    cfg = cli.build_config(types.SimpleNamespace(
        save_dir=str(tmp_path_factory.mktemp('run')), job_id=1,
        opts=['use_gpu', 'False', 'model.compute_dtype', 'float32',
              'test.batches_per_dispatch', '2']), SMOKE)
    return cli.build_model_engine(cfg)[0]


def test_engine_spans_on_the_cpu(engine, tmp_path):
    dm = engine.datamanager
    batches = [b for _, b in zip(range(2), dm.train_loader)]
    group = {k: np.stack([b[k] for b in batches])
             for k in ('image', 'mask', 'pid')}
    query = dm.test_loader['synthetic']['query']
    loader = [b for _, b in zip(range(4), iter(query))]
    assert len(loader) == 4
    with ProfilerTrace(str(tmp_path)):
        losses, _summary = engine.forward_backward_multi(group)
        engine.forward_backward(batches[0])
        feats, _vis, pids, _camids, _acc = engine.feature_extraction(loader)
    assert losses.shape == (2,)
    assert feats.shape[0] == len(pids) == sum(len(b['pid']) for b in loader)
    spans = _spans(str(tmp_path))
    fbm = spans['engine.forward_backward_multi']
    assert len(fbm) == 1 and len(spans['engine.train_inputs']) == 2
    assert len([s for s in spans['engine.train_inputs']
                if _inside([s], fbm)]) == 1
    # three eager steps on the CPU (two grouped, one alone): their
    # phases, no graph
    for name in ('engine.forward', 'engine.loss', 'engine.backward',
                 'engine.optimizer'):
        assert len(spans[name]) == 3, name
        assert len([s for s in spans[name] if _inside([s], fbm)]) == 2, name
    assert not any(name.startswith('graph.') for name in spans)
    extraction = spans['engine.feature_extraction']
    assert len(extraction) == 1
    assert len(spans['prefetch.wait']) == len(loader)
    assert _inside(spans['prefetch.wait'], extraction)
    assert len(spans['engine.gather_features']) == 1
    assert _inside(spans['engine.gather_features'], extraction)


def test_engine_run_prints_the_graph_counts(capsys):
    engine = Engine()
    engine.run()
    assert 'CUDA graph' not in capsys.readouterr().out
    engine._train_graph = types.SimpleNamespace(eager_steps=2, captures=2,
                                                replays=404)
    engine._eval_graph = types.SimpleNamespace(eager_steps=1, captures=1,
                                               replays=15)
    engine.run()
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3].startswith('Elapsed ')
    assert lines[-2:] == [
        'CUDA graph of the train step: eager 2, captures 2, replays 404',
        'CUDA graph of the eval step: eager 1, captures 1, replays 15']


@pytest.mark.cuda
def test_graph_spans_count_the_graph_calls(tmp_path):
    """A train graph under the profiler, keyed anew by a new learning
    rate: one span of each kind a call, as many as the counters; the
    eager and captured calls run the step's phases, the replays none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    clear_dataset_cache()
    cfg = cli.build_config(types.SimpleNamespace(
        save_dir=str(tmp_path / 'run'), job_id=1,
        opts=['model.compute_dtype', 'float32']), SMOKE)
    engine = cli.build_model_engine(cfg)[0]
    assert engine.train_graphs
    batches = [b for _, b in zip(range(3), engine.datamanager.train_loader)]
    group = {k: torch.as_tensor(np.stack([b[k] for b in batches])).cuda()
             for k in ('image', 'mask', 'pid')}
    with ProfilerTrace(str(tmp_path / 'trace')):
        engine.forward_backward_multi(group)
        for g in engine.optimizer.param_groups:
            g['lr'] *= 0.1
        engine.forward_backward_multi(group)
        torch.cuda.synchronize()
    graph = engine._train_graph
    assert (graph.eager_steps, graph.captures, graph.replays) == (2, 2, 4)
    spans = _spans(str(tmp_path / 'trace'))
    assert len(spans['graph.eager']) == graph.eager_steps
    assert len(spans['graph.capture']) == graph.captures
    assert len(spans['graph.replay']) == graph.replays
    assert len(spans['graph.step']) == 6
    assert len(spans['graph.clone_out']) == graph.replays
    for name in ('graph.key', 'graph.eager', 'graph.capture',
                 'graph.replay', 'graph.clone_out'):
        assert _inside(spans[name], spans['graph.step']), name
    assert len(spans['engine.forward']) == 4
    assert _inside(spans['engine.forward'],
                   spans['graph.eager'] + spans['graph.capture'])
