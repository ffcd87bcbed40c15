"""The file helpers the dataset parsers need (port of
bpbreid_tpu/utils/tools.py ``mkdir_if_missing``, ``read_json``,
``write_json``): split files are the same JSON in both packages, so
splits one writes the other reads."""
import errno
import json
import os
import os.path as osp

__all__ = ['mkdir_if_missing', 'read_json', 'write_json']


def mkdir_if_missing(dirname):
    """Create ``dirname`` (and its parents) if it is missing."""
    if not osp.exists(dirname):
        try:
            os.makedirs(dirname)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise


def read_json(fpath):
    with open(fpath, 'r') as f:
        return json.load(f)


def write_json(obj, fpath):
    """``obj`` as indented JSON at ``fpath``, its directory made first."""
    mkdir_if_missing(osp.dirname(fpath))
    with open(fpath, 'w') as f:
        json.dump(obj, f, indent=4, separators=(',', ': '))
