"""The train/test CLI of bpbreid_tpu_torch on the CPU, port only:
checkpoints (round trip, resume, refusals), preemption, ``main`` against
``build_model_engine`` + ``Engine.run``, and the options that raise.
The smoke config (``configs/bpbreid/bpbreid_synthetic_smoke.yaml``:
resnet18, synthetic data, one epoch of 4 steps) in f32. The parity of the
same run with the JAX engine is tests/test_torch_engine_run.py."""
import json
import os
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu_torch.config import engine_run_kwargs
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.avgmeter import MetricsSummary
from bpbreid_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                resume_from_checkpoint)
from bpbreid_tpu_torch.utils.engine_state import EngineState
from bpbreid_tpu_torch.utils.logging import Logger
from bpbreid_tpu_torch.utils.writer import ProfilerTrace, Writer
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')
OPTS = ['model.compute_dtype', 'float32']


def _args(save_dir, opts=()):
    return types.SimpleNamespace(save_dir=str(save_dir), job_id=1,
                                 opts=OPTS + list(opts))


def _run_kwargs(cfg):
    return dict(engine_run_kwargs(cfg), max_epoch=cfg.train.max_epoch,
                eval_freq=cfg.train.eval_freq, start_eval=cfg.test.start_eval)


def _port_engine(save_dir, opts=()):
    clear_dataset_cache()
    cfg = cli.build_config(_args(save_dir, ['use_gpu', 'False'] + list(opts)),
                           SMOKE)
    return cfg, cli.build_model_engine(cfg)[0]


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """An engine after the smoke config's epoch and final test."""
    cfg, engine = _port_engine(tmp_path_factory.mktemp('run'))
    cmc, mAP, ssmd, _ = engine.run(print_freq=2, **_run_kwargs(cfg))
    return engine, cmc, mAP, ssmd


def test_checkpoint_round_trip_and_resume(trained, tmp_path):
    engine, cmc, mAP, ssmd = trained
    path = engine.save_model(0, str(tmp_path), cmc=cmc, mAP=mAP, ssmd=ssmd,
                             is_best=True, force=True)
    assert os.path.basename(path) == 'job-1_0_model.pt'
    assert os.path.isfile(tmp_path / 'model-best.pt')
    with open(path + '.meta.json') as f:
        meta = json.load(f)
    assert set(meta) == {'epoch', 'rank1', 'mAP', 'ssmd', 'config'}
    assert meta['rank1'] == float(cmc[0])
    assert meta['config']['model']['bpbreid']['backbone'] == 'resnet18'

    _, fresh = _port_engine(tmp_path / 'fresh')
    start, _meta = resume_from_checkpoint(path, fresh.model, fresh.optimizer)
    assert start == 1
    for (k, a), b in zip(engine.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    want, got = engine.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want['param_groups'] == got['param_groups']
    assert want['state'].keys() == got['state'].keys() and want['state']
    for i, s in want['state'].items():
        for k, v in s.items():
            assert torch.equal(v, got['state'][i][k]), (i, k)

    # the CLI: model.resume starts the next epoch, load_weights the model
    _, resumed = _port_engine(tmp_path / 'resumed',
                              ['model.resume', path])
    assert resumed.start_epoch == resumed.epoch == 1
    _, loaded = _port_engine(tmp_path / 'loaded',
                             ['model.load_weights', path])
    assert loaded.start_epoch == 0
    for (k, a), b in zip(engine.model.state_dict().items(),
                         loaded.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_refuses_other_files(tmp_path):
    torchreid = tmp_path / 'model.pth'
    torch.save({'conv1.weight': torch.zeros(1)}, torchreid)
    with pytest.raises(ValueError, match='load_torch_state_dict'):
        load_checkpoint(str(torchreid))
    msgpack = tmp_path / 'job-1_0_model.ckpt'
    msgpack.write_bytes(b'\x82\xa6params\x80')
    with pytest.raises(ValueError, match='not a bpbreid_tpu_torch'):
        load_checkpoint(str(msgpack))


def test_preemption_writes_emergency_checkpoint(tmp_path):
    cfg, engine = _port_engine(tmp_path)
    step = engine.forward_backward
    calls = []

    def preempt_after_two(batch):
        calls.append(1)
        if len(calls) == 2:
            engine._request_preemption()
        return step(batch)

    engine.forward_backward = preempt_after_two
    cmc, mAP, ssmd, acc = engine.run(**_run_kwargs(cfg))
    assert len(calls) == 2
    assert not np.any(cmc) and (mAP, ssmd, acc) == (0.0, 0.0, 0.0)
    assert os.path.isfile(os.path.join(cfg.data.save_dir,
                                       'job-1_0_model.pt'))


def test_main_on_cpu_repeats_engine_run(tmp_path, monkeypatch):
    """``main`` with ``use_gpu False`` against ``build_model_engine`` +
    ``Engine.run`` on the same config: the same seeded weights and draws,
    so the same losses and metrics, bit for bit."""
    losses = []
    fb = ImagePartBasedEngine.forward_backward

    def recorded(self, batch, draws=None):
        loss, summary = fb(self, batch, draws)
        losses.append(float(loss))
        return loss, summary

    monkeypatch.setattr(ImagePartBasedEngine, 'forward_backward', recorded)
    clear_dataset_cache()
    argv = ['--config-file', SMOKE, '--save_dir', str(tmp_path / 'main'),
            '--job-id', '1', 'use_gpu', 'False'] + OPTS
    _engine, (cmc, mAP, _, _) = cli.main(argv)
    from_main = list(losses)
    losses.clear()
    cfg, engine = _port_engine(tmp_path / 'run')
    want_cmc, want_mAP, _, _ = engine.run(**_run_kwargs(cfg))
    assert len(from_main) == 4 and from_main == losses
    np.testing.assert_array_equal(cmc, want_cmc)
    assert mAP == want_mAP


def test_main_raises_without_cuda_when_use_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    clear_dataset_cache()
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--config-file', SMOKE, '--save_dir', str(tmp_path)])


@pytest.mark.parametrize('opts, error, match', [
    (['train.n_devices', '2'], NotImplementedError, 'Queue 1 item 8'),
    (['test.vis_embedding_projection', 'True'], NotImplementedError,
     'Queue 1 item 11'),
    (['data.sources', "['no_such_dataset']"], ValueError, 'Invalid dataset'),
    (['data.type', 'video', 'loss.name', 'part_based'], ValueError,
     'data.type video takes'),
])
def test_main_refuses_unported_options(tmp_path, opts, error, match):
    with pytest.raises(error, match=match):
        cli.build_config(_args(tmp_path, opts), SMOKE)


@pytest.mark.parametrize('opts', [
    ['data.type', 'video', 'loss.name', 'softmax',
     'data.sources', "['synthetic_video']"],
    ['data.sources', "['viper']"],
    ['data.sources', "['cuhk03']", 'data.targets', "['cuhk03']"],
    ['data.sources', "['occluded_duke']", 'model.bpbreid.masks.dir',
     'isp_6_parts'],
    ['data.transforms', "['rc', 're', 'ro']", 'data.load_train_targets',
     'True', 'model.bpbreid.dim_reduce', 'before_and_after_pooling'],
], ids=['video', 'viper', 'cuhk03', 'isp_6_parts', 'ro_targets_dim_reduce'])
def test_main_builds_video_small_datasets_and_occlusion_options(tmp_path, opts):
    """Options the CLI refused before the video path, the small datasets
    and BPBReID's last options were ported: the config builds as JAX's
    does (the parts count: none for video, the dataset's own for
    ``isp_6_parts``); the data and the engines are held in
    tests/test_torch_video.py, test_torch_small_datasets.py and
    test_torch_occlusion_options.py."""
    from bpbreid_tpu.scripts.main import build_config as j_build_config
    cfg = cli.build_config(_args(tmp_path / 'port', opts), SMOKE)
    jcfg = j_build_config(_args(tmp_path / 'jax', opts), SMOKE)
    for c in (cfg, jcfg):
        c.data.save_dir = ''
    for group in ('data', 'model', 'loss', 'sampler', 'video'):
        assert cfg.to_dict()[group] == jcfg.to_dict()[group], group


def test_meters_writer_and_profiler(tmp_path, capsys):
    meters = MetricsSummary()
    meters.update({'globl': {'id': torch.tensor(1.0), 'acc': 0.5}})
    meters.update({'globl': {'id': torch.tensor(3.0), 'acc': 1.5}})
    assert meters.summary_str() == 'globl: [id 2.000 acc 1.000]'
    assert meters.avg('globl', 'id') == 2.0
    state = EngineState()
    logger = Logger(save_dir=str(tmp_path))
    writer = Writer(logger=logger, engine_state=state)
    writer.batch_timer.start()
    writer.batch_timer.stop()
    writer.report_eval('synthetic', [0.5, 1.0], 0.25, 1.5)
    writer.report_global_step({'globl': {'id': torch.tensor(2.0)}}, 1e-3)
    state.run_completed()
    assert 'Phase timing summary' in capsys.readouterr().out
    assert [(s['name'], s['value']) for s in logger.scalars] == [
        ('Test/synthetic/rank1', 0.5), ('Test/synthetic/mAP', 0.25),
        ('Train/globl_id', 2.0), ('Train/lr', 1e-3)]
    stats = writer.qg_pairwise_dist_statistics(
        torch.tensor([[0.5, -1.0], [1.5, 2.0]]), None, None, None)
    assert stats['qg_dist_mean'] == pytest.approx(4.0 / 3)
    assert stats['qg_invalid_frac'] == 0.25
    assert logger.scalars[-6]['name'] == 'eval/qg_dist_mean'
    with ProfilerTrace(str(tmp_path / 'profile')):
        torch.ones(8).sum()
    assert (tmp_path / 'profile' / 'trace.json').stat().st_size > 0
