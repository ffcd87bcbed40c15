"""The CLI of bpbreid_tpu_torch with ``train.n_devices 2 use_gpu False``:
two gloo ranks spawned by ``scripts.main.main``, against the one-process
run of the same config, and the device-count rules and messages of
``maybe_distribute_engine`` against JAX's.

The smoke config (resnet18 BPBReID, synthetic data, one epoch of 4
steps of 8 images, the final test), f32, every step's losses logged
(``train.batch_log_freq 1``) and written by rank 0 to ``scalars.json``.
Tolerances: every logged loss to 1e-4 relative (the ranks sum in
another order; the accuracies and the learning rate exactly), mAP to
1e-3 and rank-1 equal. The run writes the one-process run's files, once.
"""
import json
import os
import threading

import pytest

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.scripts.main import maybe_distribute_engine as j_maybe
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.scripts import main as cli
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')
OPTS = ['use_gpu', 'False', 'model.compute_dtype', 'float32',
        'train.batch_log_freq', '1']


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('parallel_cli')
    out = {}

    def run(name, extra):
        engine, result = cli.main(['--config-file', SMOKE, '--job-id', '1',
                                   '--save_dir', str(tmp / name)]
                                  + OPTS + extra)
        root = str(tmp / name / '1')
        with open(os.path.join(root, 'scalars.json')) as f:
            scalars = json.load(f)
        out[name] = {'engine': engine, 'result': result,
                     'scalars': scalars, 'files': _files(root)}

    # the spawned ranks' torch threads: the port tests' two, shared
    old = os.environ.get('OMP_NUM_THREADS')
    os.environ['OMP_NUM_THREADS'] = '2'
    clear_dataset_cache()
    # the 2-rank run waits on its spawned ranks in a thread while this
    # thread runs the one-process run
    two = threading.Thread(target=run, args=('two', ['train.n_devices',
                                                     '2']))
    try:
        two.start()
        run('one', [])
    finally:
        two.join()
        if old is None:
            del os.environ['OMP_NUM_THREADS']
        else:
            os.environ['OMP_NUM_THREADS'] = old
    assert set(out) == {'one', 'two'}, 'the 2-rank run failed'
    return out


def test_two_ranks_give_the_one_process_losses(runs):
    one, two = runs['one']['scalars'], runs['two']['scalars']
    assert [s['name'] for s in one] == [s['name'] for s in two]
    train = [(a, b) for a, b in zip(one, two)
             if a['name'].startswith('Train/')]
    assert len(train) == 4 * 12         # 4 steps, 11 loss terms + lr
    for a, b in train:
        assert b['value'] == pytest.approx(a['value'], rel=1e-4), a['name']
        if a['name'].endswith(('_a', '_tt', '_vt', '/lr')):
            assert b['value'] == a['value'], a['name']


def test_two_ranks_give_the_one_process_metrics(runs):
    (cmc1, map1, _, _), (cmc2, map2, _, _) = (runs[k]['result']
                                              for k in ('one', 'two'))
    assert runs['one']['engine'] is not None
    assert runs['two']['engine'] is None      # the ranks held the engines
    assert cmc2[0] == cmc1[0]
    assert map2 == pytest.approx(map1, abs=1e-3)


def test_rank_0_writes_the_files_once(runs):
    assert runs['two']['files'] == runs['one']['files']
    assert 'scalars.json' in runs['two']['files']


def _cfgs(n_devices, batch_size):
    out = []
    for cfg in (j_default_config(), get_default_config()):
        cfg.train.n_devices, cfg.train.batch_size = n_devices, batch_size
        out.append(cfg)
    return out


class _JaxEngine:
    """What JAX's ``maybe_distribute_engine`` reads of an engine."""
    _train_step_impl = staticmethod(lambda *a: None)
    state = None


@pytest.mark.parametrize('n_devices, batch_size, want', [
    (8, 100, None),           # requested, not a divisor: ValueError
    (0, 100, 5),              # automatic: the largest divisor that fits
    (16, 64, 8),              # above the visible devices: clamped
    (0, 7, 7),
    (0, 11, 1),               # automatic, no divisor above 1 that fits
    (4, 64, 4),
])
def test_device_count_rules_and_messages_match_jax(capsys, n_devices,
                                                   batch_size, want):
    """JAX's rules on its 8 CPU devices, the port's with 8 visible cards:
    the same count, the same ValueError and the same printed lines."""
    jcfg, cfg = _cfgs(n_devices, batch_size)
    if want is None:
        with pytest.raises(ValueError) as j_err:
            j_maybe(_JaxEngine(), jcfg)
        with pytest.raises(ValueError) as err:
            cli.n_devices_for(cfg, available=8)
        assert str(err.value) == str(j_err.value)
        assert 'n_devices=5' in str(err.value)
        return
    mesh = j_maybe(_JaxEngine(), jcfg)
    j_lines = capsys.readouterr().out.splitlines()
    assert cli.n_devices_for(cfg, available=8) == want
    lines = capsys.readouterr().out.splitlines()
    assert (mesh.devices.size if mesh is not None else 1) == want
    # JAX's last line names its mesh; the rules' lines come before it
    assert lines == (j_lines[:-1] if want > 1 else j_lines)


def test_one_rank_is_not_distributed(tmp_path):
    """``maybe_distribute_engine`` on one device returns None and leaves
    the engine as it is (no process group needed)."""
    cfg = get_default_config()
    cfg.use_gpu = False
    engine = type('E', (), {'mesh': None})()
    assert cli.maybe_distribute_engine(engine, cfg) is None
    assert engine.mesh is None
