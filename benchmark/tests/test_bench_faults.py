"""The rest of a run, with the timed path broken underneath, comes out
not correct against each real cell's limits: a train step that leaves its
state unchanged, a train step on half of its batch (the mean over the
rest), an eval answer (the features or the visibility) altered where it
is produced. The cells run on one chip, so no exchange between chips can
be left out. The unbroken tiny runs are correct."""
import pytest
import torch

from benchmark import core
from benchmark.tests.tiny import tiny_cell, tiny_root
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine

SEED = 3000000037
TRAIN = ['train.bpbreid_hrnet32', 'train.bpbreid_resnet50']
EMBED = ['embed.bpbreid_hrnet32', 'embed.bpbreid_resnet50']


def _run(tmp_path, kind, real):
    root = tiny_root(tmp_path, real={kind: real})
    return core.run_cell(tiny_cell(root, kind), SEED, 0.3, 0, 'cpu')


def _failed(res):
    return [n for n, c in res['checks'].items() if c['value'] > c['limit']]


@pytest.mark.parametrize('real', TRAIN + EMBED)
def test_sound_run_is_correct(tmp_path, real):
    res = _run(tmp_path, real.split('.')[0], real)
    assert res['correct'] is True, res['checks']


@pytest.mark.parametrize('real', TRAIN)
def test_state_left_unchanged(tmp_path, monkeypatch, real):
    monkeypatch.setattr(ImagePartBasedEngine, 'optimizer_step',
                        lambda self, loss: None)
    res = _run(tmp_path, 'train', real)
    assert res['correct'] is False
    # nothing moved: the parameters' change reads 1 (to the median
    # leaf's rounding where that leaf is one of two middle ones)
    assert max(c['value'] for c in res['checks'].values()) > 0.99


@pytest.mark.parametrize('real', TRAIN)
def test_half_batch(tmp_path, monkeypatch, real):
    step = ImagePartBasedEngine.train_step

    def half(self, imgs, masks, pids, draws=None):
        n = imgs.shape[0] // 2
        return step(self, imgs[:n], None if masks is None else masks[:n],
                    pids[:n], draws)
    monkeypatch.setattr(ImagePartBasedEngine, 'train_step', half)
    res = _run(tmp_path, 'train', real)
    assert res['correct'] is False
    assert _failed(res)


@pytest.mark.parametrize('what', ['features', 'visibility'])
@pytest.mark.parametrize('real', EMBED)
def test_answer_altered(tmp_path, monkeypatch, real, what):
    outputs = ImagePartBasedEngine._eval_outputs

    def altered(self, imgs, masks):
        feats, vis, corr, tot = outputs(self, imgs, masks)
        if what == 'features':
            bump = torch.zeros_like(feats)
            bump[0] = feats[0].abs().mean()
            return feats + bump, vis, corr, tot
        vis = vis.clone()
        vis[0] = (vis[0] == 0).to(vis.dtype)
        return feats, vis, corr, tot
    monkeypatch.setattr(ImagePartBasedEngine, '_eval_outputs', altered)
    res = _run(tmp_path, 'embed', real)
    assert res['correct'] is False
