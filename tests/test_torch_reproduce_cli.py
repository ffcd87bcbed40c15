"""``tools/reproduce.py`` of bpbreid_tpu_torch on its own, on the CPU
(the tree and the checkpoint of tests/test_torch_reproduce.py, which
holds the tool against JAX's): ``main`` exits with 1 past
``--max-delta`` and 0 within it and writes ``--json-out``; a checkpoint
without stored metrics prints n/a and passes any ``--max-delta``; a file
whose metrics cannot be read raises (JAX passes over it).
"""
import os.path as osp

import numpy as np
import pytest

from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.tools import reproduce as tool
from tests.test_torch_reproduce import OPTS, _port, tree  # noqa: F401
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def test_main_exits_1_past_max_delta(tree, capsys):
    root, ckpt, _ = tree
    clear_dataset_cache()
    argv = ['--checkpoint', ckpt, '--root', root,
            '--save_dir', osp.join(root, 'main'),
            '--masks-dir', 'pifpaf_maskrcnn_filtering',
            '--json-out', osp.join(root, 'result.json')]
    rc = tool.main(argv + ['--max-delta', '1e-9'] + OPTS
                   + ['use_gpu', 'False'])
    assert rc == 1 and 'FAIL: |' in capsys.readouterr().out
    clear_dataset_cache()
    assert tool.main(argv + ['--max-delta', '2'] + OPTS
                     + ['use_gpu', 'False']) == 0
    assert osp.exists(osp.join(root, 'result.json'))


def test_stored_metrics_missing_or_unreadable(tree, capsys):
    root, _, bare = tree
    got = _port(root, bare, 'bare', max_delta=1e-9)
    assert got['stored'] == {} and got['ok']
    assert np.isnan(got['delta_mAP'])
    assert 'n/a' in capsys.readouterr().out
    broken = osp.join(root, 'broken.pth')
    with open(broken, 'wb') as f:
        f.write(b'not a checkpoint')
    with pytest.raises(Exception):
        tool.stored_metrics(broken)
