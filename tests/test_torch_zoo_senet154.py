"""SENet-154 and SE-ResNeXt-101 of bpbreid_tpu_torch at full depth: each
builds the JAX package's variable tree key for key and gives a finite
eval embedding at 64x32, two images (as
``tests/test_torch_zoo_senet_constructors.py``). ``senet154``'s
three-conv stem, doubled ``conv1`` widths, 64 groups and 3x3
downsampling convs.
"""
import pytest

from bpbreid_tpu.models import senet as jsenet
from bpbreid_tpu_torch.models import senet as tsenet
from tests.torch_port_helpers import check_zoo_constructor, limit_torch_threads

limit_torch_threads()


@pytest.mark.parametrize('name', ['se_resnext101_32x4d', 'senet154'])
def test_senet_constructors(name):
    tm = getattr(tsenet, name)(7)
    out = check_zoo_constructor(getattr(jsenet, name)(7), tm, (64, 32))
    assert tuple(out.shape) == (2, 2048) == (2, tm.feature_dim)
