"""``tools/reproduce.py`` of bpbreid_tpu_torch against the JAX package's
``reproduce``, on the CPU: a fabricated mini Market-1501 tree (PNG data
under the parser's ``.jpg`` names, so both packages decode the same
pixels) and a torchreid-format checkpoint saved from a seeded port model
(its state dict, stored ``rank1`` / ``mAP`` and model config). Both
tools load it, test, and report the same mAP and rank-1 (1e-6) beside
the stored values. The tool's exit code, ``--max-delta`` and the stored
metrics' edge cases: tests/test_torch_reproduce_cli.py.
"""
import os
import os.path as osp

import numpy as np
import pytest
import torch

from bpbreid_tpu.data.datasets import clear_dataset_cache as j_clear
from bpbreid_tpu.tools.reproduce import reproduce as j_reproduce
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.data.datasets.dataset import write_png
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.tools import reproduce as tool
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

MODEL_CFG = {'backbone': 'resnet18', 'last_stride': 1,
             'dim_reduce': 'after_pooling', 'dim_reduce_output': 32,
             'pooling': 'gwap', 'learnable_attention_enabled': True,
             'mask_filtering_testing': True,
             'masks': {'preprocess': 'five_v', 'parts_num': 5}}
OPTS = ['data.height', '32', 'data.width', '16', 'test.batch_size', '16',
        'train.batch_size', '8', 'model.compute_dtype', 'float32']


def _make_market_tree(root, num_pids=4, num_cams=2, imgs=2, h=32, w=16):
    base = osp.join(root, 'Market-1501-v15.09.15')
    rng = np.random.default_rng(0)
    colors = {pid: rng.integers(0, 200, 3) for pid in range(1, num_pids + 1)}
    for sub, per_cam in (('bounding_box_train', imgs), ('query', 1),
                         ('bounding_box_test', imgs)):
        d = osp.join(base, sub)
        md = osp.join(base, 'masks', 'pifpaf_maskrcnn_filtering', sub)
        os.makedirs(d)
        os.makedirs(md)
        frame = 0
        for pid in range(1, num_pids + 1):
            for cam in range(1, num_cams + 1):
                for _ in range(per_cam):
                    frame += 1
                    name = '{:04d}_c{}s1_{:06d}_00'.format(pid, cam, frame)
                    write_png(osp.join(d, name + '.jpg'), (
                        colors[pid][None, None, :]
                        + rng.integers(0, 56, (h, w, 3))).astype(np.uint8))
                    np.save(osp.join(md, name + '.npy'), rng.random(
                        (36, h // 8, w // 8)).astype(np.float32))


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('reproduce')
    _make_market_tree(str(root))
    cfg = get_default_config()
    cfg.merge_from_dict({'model': {'bpbreid': MODEL_CFG}})
    model = build_model('bpbreid', 4, config=cfg, device='cpu', seed=3)
    with torch.no_grad():          # running statistics away from 0 / 1
        gen = torch.Generator().manual_seed(4)
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith('running_var'):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    sd = {'module.' + k: v for k, v in model.state_dict().items()}
    ckpt = osp.join(str(root), 'job-1_120_model.pth.tar')
    torch.save({'state_dict': sd, 'epoch': 120, 'rank1': 0.75, 'mAP': 0.5,
                'config': {'model': {'bpbreid': MODEL_CFG}}}, ckpt)
    bare = osp.join(str(root), 'bare.pth')
    torch.save({'state_dict': sd}, bare)
    return str(root), ckpt, bare


def _port(root, ckpt, save, **kw):
    clear_dataset_cache()
    return tool.reproduce(ckpt, root, dataset='market1501',
                          save_dir=osp.join(root, save),
                          masks_dir='pifpaf_maskrcnn_filtering',
                          opts=OPTS + ['use_gpu', 'False'], **kw)


def test_reproduce_equals_jax(tree):
    root, ckpt, _ = tree
    got = _port(root, ckpt, 'port')
    j_clear()
    want = j_reproduce(ckpt, root, dataset='market1501',
                       save_dir=osp.join(root, 'jax'),
                       masks_dir='pifpaf_maskrcnn_filtering', opts=OPTS)
    assert got['stored'] == want['stored'] == {'rank1': 0.75, 'mAP': 0.5,
                                               'epoch': 120.0}
    for key in ('mAP', 'rank1', 'delta_mAP', 'delta_rank1'):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert got['ok'] and want['ok']
