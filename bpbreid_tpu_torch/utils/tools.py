"""General-purpose helpers (port of bpbreid_tpu/utils/tools.py; the
reference's torchreid/utils/tools.py:1-187).

Split files are the same JSON in both packages, so splits one writes the
other reads. ``read_image`` and ``read_masks`` are the dataset layer's
(``data/datasets/dataset.py``: the port's own PNG decoder, PIL for other
formats, and the ``.npy`` reader), re-exported here as JAX does.
"""
import errno
import json
import os
import os.path as osp
import platform
import random
import sys
import time
import warnings

import numpy as np

__all__ = ['mkdir_if_missing', 'check_isfile', 'read_json', 'write_json',
           'set_random_seed', 'download_url', 'collect_env_info',
           'read_image', 'read_masks']


def mkdir_if_missing(dirname):
    """Create ``dirname`` (and its parents) if it is missing."""
    if not osp.exists(dirname):
        try:
            os.makedirs(dirname)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise


def check_isfile(fpath):
    """True if ``fpath`` is a file; warns otherwise."""
    isfile = osp.isfile(fpath)
    if not isfile:
        warnings.warn('No file found at "{}"'.format(fpath))
    return isfile


def read_json(fpath):
    with open(fpath, 'r') as f:
        return json.load(f)


def write_json(obj, fpath):
    """``obj`` as indented JSON at ``fpath``, its directory made first."""
    mkdir_if_missing(osp.dirname(fpath))
    with open(fpath, 'w') as f:
        json.dump(obj, f, indent=4, separators=(',', ': '))


def set_random_seed(seed):
    """Seed Python's, numpy's and torch's generators (torch's seeds every
    CUDA device too), as the reference does."""
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def download_url(url, dst):
    """Download ``url`` to ``dst`` with a progress line."""
    from urllib.request import urlretrieve
    print('* url="{}"'.format(url))
    print('* destination="{}"'.format(dst))
    start = time.time()

    def _reporthook(count, block_size, total_size):
        duration = max(time.time() - start, 1e-9)
        progress_size = int(count * block_size)
        speed = int(progress_size / (1024 * duration))
        percent = min(int(count * block_size * 100 / max(total_size, 1)), 100)
        sys.stdout.write(
            '\r...%d%%, %d MB, %d KB/s, %d seconds passed'
            % (percent, progress_size / (1024 * 1024), speed, duration))
        sys.stdout.flush()

    urlretrieve(url, dst, _reporthook)
    sys.stdout.write('\n')


def collect_env_info():
    """Environment summary for logs: Python, the platform, torch and its
    CUDA version, the cards' names (or why there are none) and numpy."""
    import torch
    lines = ['python: {}'.format(platform.python_version()),
             'platform: {}'.format(platform.platform()),
             'torch: {}'.format(torch.__version__),
             'cuda: {}'.format(torch.version.cuda)]
    if torch.cuda.is_available():
        lines.append('devices: {}'.format(
            [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]))
    else:
        lines.append('devices: no CUDA device')
    lines.append('numpy: {}'.format(np.__version__))
    return '\n'.join(lines)


def read_image(path):
    from bpbreid_tpu_torch.data.datasets.dataset import read_image as _impl
    return _impl(path)


def read_masks(path):
    from bpbreid_tpu_torch.data.datasets.dataset import read_masks as _impl
    return _impl(path)
