"""The port's spans (``bpbreid_tpu_torch/utils/tracing.py``): unprofiled,
``span`` never enters ``record_function``; profiled, each span is a
``user_annotation`` event of the profiler's Chrome trace on the wall
clock, and a tiny engine's train group and feature extraction leave the
spans the benchmark's readers take (``benchmark/metrics/``);
``eval_preprocess`` names the mask path it took. The CUDA
graph's spans (``engine/graphs.py``) are counted against its counters on
the card (marker ``cuda``). The softmax engine's train step has the
part-based engine's ``engine.forward`` and ``engine.loss``, and an
``OptaxRule`` the span ``optim.scalars`` of its device scalars: on eager and capturing calls, none on a replay (on the card).
``Engine.run`` ends with the graphs' counts.
No module here imports JAX: the card's test run imports this file."""
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.augment import (eval_preprocess,
                                            mask_chain_kwargs)
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.engine import Engine
from bpbreid_tpu_torch.optim.optimizer import OptaxRule
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


@pytest.mark.parametrize('field_hw,name', [
    ((8, 4), 'augment.eval_masks_grid'),
    ((64, 32), 'augment.eval_masks_grid'),
    ((128, 64), 'augment.eval_masks_full'),
    ((128, 16), 'augment.eval_masks_full'),
    ((32, 48), 'augment.eval_masks_full')])
def test_eval_preprocess_spans_name_the_mask_path(monkeypatch, field_hw,
                                                  name):
    """Fields at 1/8 of the image grid or at the grid itself run the
    feature-grid mask chain, fields larger than it in either axis the
    full-resolution one: one span, of that path, a call."""
    entered = _counting(monkeypatch)
    imgs = torch.zeros((2, 64, 32, 3), dtype=torch.uint8)
    fields = torch.rand((2,) + field_hw + (36,),
                        generator=torch.Generator().manual_seed(0))
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    kw = mask_chain_kwargs(cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, masks = eval_preprocess(imgs, fields, mask_kwargs=kw)
    assert tuple(masks.shape) == (2, 6, 16, 8)
    assert entered == [name]


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


def _softmax_engine(tmp_path, device):
    """An OSNet (``osnet_x0_25`` at 64x32, float32, batch 8, random flip)
    under the softmax engine with amsgrad, as the CLI builds them."""
    clear_dataset_cache()
    cfg = cli.build_config(types.SimpleNamespace(
        save_dir=str(tmp_path), job_id=1, opts=[
            'use_gpu', str(device != 'cpu'), 'model.compute_dtype',
            'float32', 'data.sources', "['synthetic']", 'data.targets',
            "['synthetic']", 'data.height', '64', 'data.width', '32',
            'data.transforms', "['random_flip']", 'loss.name', 'softmax',
            'model.name', 'osnet_x0_25', 'train.optim', 'amsgrad',
            'train.batch_size', '8', 'sampler.num_instances', '4']), None)
    engine = cli.build_model_engine(cfg)[0]
    batches = [b for _, b in zip(range(3), engine.datamanager.train_loader)]
    group = {k: torch.as_tensor(np.stack([b[k] for b in batches]))
             .to(device) for k in ('image', 'pid')}
    return engine, group


@pytest.mark.parametrize('optim', ['amsgrad', 'sgd'])
def test_softmax_engine_spans_on_the_cpu(tmp_path, optim):
    """Three eager steps of a group: each has the part-based engine's
    four phases; amsgrad adds its ``optim.scalars`` inside
    ``engine.optimizer``, SGD none."""
    engine, group = _softmax_engine(tmp_path / 'run', 'cpu')
    if optim == 'sgd':
        engine.optimizer = torch.optim.SGD(engine.model.parameters(),
                                           lr=1e-3)
    assert isinstance(engine.optimizer, OptaxRule) is (optim == 'amsgrad')
    with ProfilerTrace(str(tmp_path / 'trace')):
        losses, _summary = engine.forward_backward_multi(group)
    assert losses.shape == (3,)
    spans = _spans(str(tmp_path / 'trace'))
    fbm = spans['engine.forward_backward_multi']
    for name in ('engine.forward', 'engine.loss', 'engine.backward',
                 'engine.optimizer'):
        assert len(spans[name]) == 3, name
        assert _inside(spans[name], fbm), name
    if optim == 'amsgrad':
        assert len(spans['optim.scalars']) == 3
        assert _inside(spans['optim.scalars'], spans['engine.optimizer'])
    else:
        assert 'optim.scalars' not in spans


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


@pytest.mark.cuda
def test_softmax_graph_spans(tmp_path):
    """The softmax engine's group of three steps through the train graph
    with amsgrad, its step count on the card:
    the eager step and the capture run ``engine.forward``,
    ``engine.loss`` and ``optim.scalars``, the replays none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    engine, group = _softmax_engine(tmp_path / 'run', 'cuda')
    assert isinstance(engine.optimizer, OptaxRule)
    assert engine.train_graphs
    with ProfilerTrace(str(tmp_path / 'trace')):
        engine.forward_backward_multi(group)
        torch.cuda.synchronize()
    graph = engine._train_graph
    assert (graph.eager_steps, graph.captures, graph.replays) == (1, 1, 2)
    spans = _spans(str(tmp_path / 'trace'))
    calls = spans['graph.eager'] + spans['graph.capture']
    for name in ('engine.forward', 'engine.loss', 'optim.scalars'):
        assert len(spans[name]) == 2, name
        assert _inside(spans[name], calls), name
    assert float(engine.optimizer.param_groups[0]['step']) == 3
