"""The rules that choose between the CUDA graph path and eager steps
(``engine/engine.py Engine.train_graphs``, ``steps_per_dispatch``),
decided from the configuration alone, the checkpoints of a capturable
Adam (``utils/checkpoint.py load_optimizer_state``) and the kept
constants of the captured steps (``ops/tensortools.py constant``), on
the CPU; and the CPU rehearsal of what a capture refuses: after a warm
step, the train step and the eval step of the CLI's engines (the smoke
config's BPBReID with int8 eval, an OSNet with the softmax engine, a
video resnet18) make no tensor from host data and read nothing back
(``HostSyncRecorder``; the optimizer's step excluded: on the card Adam
runs ``capturable``, here SGD stands in for it). The graphs themselves
run on the card (tests/test_torch_cuda.py, chip_smoke.py phase 18).
The ``OptaxRule`` optimizers (amsgrad, rmsprop, radam), whose step
counts live on the parameters' device, are graph-capturable by the same
rule, and their step, warm, reads nothing on the host either."""
import types

import pytest
import torch

from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.engine import Engine
from bpbreid_tpu_torch.engine.video.softmax import flatten_tracklets
from bpbreid_tpu_torch.optim import build_optimizer
from bpbreid_tpu_torch.optim.optimizer import OptaxRule
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.checkpoint import load_optimizer_state
from tests.torch_port_helpers import HostSyncRecorder, limit_torch_threads

limit_torch_threads()


def _engine(optimizer, device='cpu', config=None):
    engine = Engine(config=config)
    engine.device = torch.device(device)
    engine.model = torch.nn.Linear(3, 2)
    engine.optimizer = optimizer(engine.model)
    return engine


OPTIMIZERS = {
    'adam_capturable': (lambda m: torch.optim.Adam(m.parameters(),
                                                   capturable=True), True),
    'adam': (lambda m: torch.optim.Adam(m.parameters()), False),
    'sgd': (lambda m: build_optimizer(m, optim='sgd'), True),
    'radam': (lambda m: build_optimizer(m, optim='radam'), True),
    'rmsprop': (lambda m: build_optimizer(m, optim='rmsprop'), True),
    'amsgrad': (lambda m: build_optimizer(m, optim='amsgrad'), True),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_engine_train_graphs_rule(name):
    """Graphs on a CUDA device without a mesh, with an optimizer whose
    step reads nothing on the host; the rule reads the configuration
    alone (no card is needed to decide)."""
    make, want = OPTIMIZERS[name]
    engine = _engine(make, 'cuda')
    assert engine.eval_graphs is True
    assert engine.train_graphs is want
    engine.mesh = types.SimpleNamespace(size=2, rank=0)
    assert engine.train_graphs is False and engine.eval_graphs is False
    assert _engine(make, 'cpu').train_graphs is False


def test_adam_is_capturable_only_on_the_card():
    """``build_optimizer`` builds Adam ``capturable`` over parameters on
    a CUDA device (tests/test_torch_cuda.py); on the CPU it cannot be."""
    opt = build_optimizer(torch.nn.Linear(3, 2), optim='adam')
    assert all(g['capturable'] is False for g in opt.param_groups)


def test_steps_per_dispatch_from_the_config():
    cfg = get_default_config()
    engine = Engine(config=cfg)
    assert engine.steps_per_dispatch == 8
    assert engine.batches_per_dispatch == 8
    cfg.train.batch_debug_freq = 5
    assert engine.steps_per_dispatch == 1
    assert Engine().steps_per_dispatch == Engine().batches_per_dispatch == 1


def _stepped_adam(capturable):
    model = torch.nn.Linear(3, 2)
    opt = build_optimizer(model, optim='adam', lr=1e-3)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = opt.state_dict()
    for group in state['param_groups']:
        group['capturable'] = capturable
    return model, state


@pytest.mark.parametrize('saved, own', [(True, False), (False, True),
                                        (True, True)])
def test_optimizer_state_keeps_its_own_capturable(saved, own):
    """A capturable Adam's checkpoint loads into an eager Adam and back:
    each keeps its own ``capturable``, the step count as f32 (on the
    host for an eager Adam, on the parameters' device for a capturable
    one: here both the CPU), and the moments."""
    model, state = _stepped_adam(saved)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, capturable=own)
    load_optimizer_state(opt, state)
    assert all(g['capturable'] is own for g in opt.param_groups)
    for p in model.parameters():
        st = opt.state[p]
        assert st['step'].dtype == torch.float32 and float(st['step']) == 1
        assert st['step'].device.type == 'cpu'
        assert st['exp_avg'].abs().sum() > 0


def test_sgd_state_gains_no_capturable():
    model = torch.nn.Linear(3, 2)
    sgd = build_optimizer(model, optim='sgd', lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    sgd.step()
    state = sgd.state_dict()
    other = build_optimizer(model, optim='sgd', lr=0.1)
    load_optimizer_state(other, state)
    assert all('capturable' not in g for g in other.param_groups)
    assert other.state_dict()['state'].keys() == state['state'].keys()


def test_kept_constants_serve_autograd_after_inference_mode():
    """A constant first asked for under ``torch.inference_mode`` (an eval
    step) is a normal tensor, so a later train step may use it in
    autograd; a second call returns the kept tensor."""
    from bpbreid_tpu_torch.ops.resize import (linear_matrix_align_corners,
                                              resize_bilinear_align_corners)
    from bpbreid_tpu_torch.ops.tensortools import constant
    with torch.inference_mode():
        m = linear_matrix_align_corners(5, 9, 'cpu')
        c = constant(('rules-test', 3), 'cpu', lambda: [1.0, 2.0, 3.0])
    assert not m.is_inference() and not c.is_inference()
    assert linear_matrix_align_corners(5, 9, 'cpu') is m
    x = torch.randn(2, 3, 5, 4, requires_grad=True)
    resize_bilinear_align_corners(x, 9, 7).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


SMOKE = 'configs/bpbreid/bpbreid_synthetic_smoke.yaml'
SMALL_SET = ['data.sources', "['synthetic']", 'data.targets',
             "['synthetic']", 'data.height', '64', 'data.width', '32',
             'train.batch_size', '8', 'sampler.num_instances', '4',
             'test.batch_size', '8']
REHEARSALS = {
    'bpbreid_int8': (SMOKE, ['test.int8', 'True', 'data.transforms',
                             "['rf', 'rc', 're']"]),
    'osnet_softmax': (None, SMALL_SET + ['loss.name', 'softmax',
                                         'model.name', 'osnet_x0_25']),
    'video_resnet18': (None, [
        'data.type', 'video', 'data.sources', "['synthetic_video']",
        'data.targets', "['synthetic_video']", 'data.height', '64',
        'data.width', '32', 'loss.name', 'softmax', 'model.name',
        'resnet18', 'video.seq_len', '2', 'train.batch_size', '2',
        'test.batch_size', '2', 'sampler.train_sampler', 'RandomSampler']),
}


@pytest.mark.parametrize('case', sorted(REHEARSALS))
def test_steps_capture_safe(case, tmp_path):
    """After a warm step, the train step (``train_step``) and the eval
    step that the graphs capture make no tensor from host data, read
    nothing back and index by no mask."""
    config, opts = REHEARSALS[case]
    clear_dataset_cache()
    args = types.SimpleNamespace(save_dir=str(tmp_path), job_id=1, opts=[
        'use_gpu', 'False', 'model.compute_dtype', 'float32',
        'train.optim', 'sgd'] + opts)
    cfg = cli.build_config(args, config)
    engine, _model = cli.build_model_engine(cfg)
    batch = next(iter(engine.datamanager.train_loader))
    if cfg.data.type == 'video':
        batch = flatten_tracklets(batch)
    inputs = engine.train_inputs(batch)
    engine.train_step(*inputs)
    with HostSyncRecorder() as rec:
        engine.train_step(*inputs)
    assert rec.found == [], rec.found

    loader = engine.datamanager.test_loader[cfg.data.targets[0]]['query']
    b = next(iter(loader))
    images = torch.as_tensor(b['image'])
    if hasattr(engine, '_eval_outputs'):
        engine._eval_quant_opts = engine.int8_quant_opts([b])
        assert engine._eval_quant_opts is not None
        masks = torch.as_tensor(b['mask'])
        step = (lambda: engine._eval_outputs(images, masks))  # noqa: E731
    elif cfg.data.type == 'video':
        step = (lambda: engine.tracklet_embeddings(images))  # noqa: E731
    else:
        step = (lambda: engine.eval_step(images))  # noqa: E731
    step()
    with HostSyncRecorder() as rec:
        step()
    assert rec.found == [], rec.found


@pytest.mark.parametrize('rule', ['amsgrad', 'rmsprop', 'radam'])
def test_optax_rule_step_is_capture_safe(rule):
    """An ``OptaxRule``'s step, after a warm one (which makes
    the moments), with weight decay and radam on either side of its
    switch: no tensor from host data, no read back."""
    model = torch.nn.Linear(3, 2)
    opt = OptaxRule(model.parameters(), rule, lr=1e-3, weight_decay=5e-4)
    for step in range(8):
        model(torch.ones(4, 3)).sum().backward()
        if step == 0:
            opt.step()
            continue
        with HostSyncRecorder() as rec:
            opt.step()
        assert rec.found == [], (step, rec.found)
    assert float(opt.param_groups[0]['step']) == 8


def test_host_sync_recorder_finds_host_reads():
    """The recorder sees what a capture refuses."""
    x = torch.arange(6.0)
    with HostSyncRecorder() as rec:
        torch.tensor([1.0, 2.0])
        float(x.sum())
        x[x > 2]
        torch.full((), 2.0)
        torch.nn.functional.one_hot(torch.arange(3), 3)
    kinds = [what for what, _ in rec.found]
    assert any('lift_fresh' in k for k in kinds)
    assert any('_local_scalar_dense' in k or k == '__float__'
               for k in kinds)
    assert any('index' in k or 'nonzero' in k for k in kinds)
    assert not any('full' in k or 'one_hot' in k for k in kinds)
