"""The control of each traffic kind, at a size a test run holds: the
lower precision put in the program's place fails each real cell's limits
on at least one number. ``train``: the reference with float8 products;
``embed``: the program's own int8 path. ``benchmark/calibrate.py`` reads the same controls on the card at
the cells' own sizes."""
import pytest
import torch

from benchmark import calibrate, core
from benchmark.tests.tiny import tiny_cell, tiny_root

SEED = 3000000041


def _readings(tmp_path, kind, real):
    cell = tiny_cell(tiny_root(tmp_path, real={kind: real}), kind)
    traffic = core.load_traffic(kind)

    def ctx_for(seed):
        return traffic.Traffic(core.Context(cell, seed, 'cpu'))
    if kind == 'train':
        rows = calibrate.train_readings(ctx_for, SEED, True)
    else:
        rows = calibrate.embed_readings(ctx_for, SEED, True, 0.3)
    return cell.workload['limits'], {what: r for what, r, _ in rows}


def _fails(limits, readings):
    return [n for n, lim in limits.items() if readings[n] > lim]


@pytest.mark.parametrize('real', ['train.bpbreid_hrnet32',
                                  'train.bpbreid_resnet50'])
def test_train_control_fails(tmp_path, real):
    limits, rows = _readings(tmp_path, 'train', real)
    assert not _fails(limits, rows['sound'])
    assert _fails(limits, rows['control'])
    assert _fails(limits, rows['fault_half_batch'])


@pytest.mark.parametrize('real', ['embed.bpbreid_hrnet32',
                                  'embed.bpbreid_resnet50'])
def test_embed_control_fails(tmp_path, real):
    limits, rows = _readings(tmp_path, 'embed', real)
    assert not _fails(limits, rows['sound'])
    assert _fails(limits, rows['control'])


def test_calibrate_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert calibrate.main(['--workload', 'train.bpbreid_hrnet32']) == 2
