"""``bpbreid_tpu_torch.tools.bench_train`` on the CPU at a small size
(resnet18 at 64x32, batch 8, 2 timed loops of 2 grouped steps, one
repetition): its JSON record has the JAX tool's keys and metric name
(bpbreid_tpu/tools/bench_train.py), names the device, and with
``--profile`` writes the Chrome trace that ``tools.profile_summary``
reads and marks the record ``_profiled``. No number it prints here is a
device measurement: the tool times the card when run there."""
import json

import pytest

from bpbreid_tpu_torch.tools import bench_train, profile_summary
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

ARGS = ['--device', 'cpu', '--backbone', 'resnet18', '--height', '64',
        '--width', '32', '--batch-size', '8', '--iters', '2',
        '--repeats', '1', '--steps-per-dispatch', '2']
# the JAX tool's record: bpbreid_tpu/tools/bench_train.py main
JAX_KEYS = {'metric', 'value', 'unit', 'step_ms', 'runs_ms'}
JAX_METRIC = '{}_bpbreid_train_step_{}x{}_b{}{}'.format(
    'resnet18', 64, 32, 8, '_spd2')


@pytest.mark.parametrize('profiled', [False, True])
def test_bench_train_record(profiled, tmp_path, capsys):
    argv = ARGS + (['--profile', str(tmp_path / 'trace')] if profiled
                   else [])
    record = bench_train.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == record
    assert JAX_KEYS <= set(record)
    assert record['unit'] == 'images/sec/chip'
    assert record['device'] == 'cpu' and record['graphs'] is False
    assert record['value'] > 0 and len(record['runs_ms']) == 1
    if not profiled:
        assert record['metric'] == JAX_METRIC
        return
    assert record['metric'] == JAX_METRIC + '_profiled'
    assert record['profiled'] is True
    path = profile_summary.find_trace(str(tmp_path / 'trace'))
    rows, _cats, total_ns, label = profile_summary.summarize(path)
    assert rows and total_ns > 0 and 'CPU' in label
