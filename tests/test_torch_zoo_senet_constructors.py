"""The SENet constructors of bpbreid_tpu_torch beside ``se_resnet50``
(``tests/test_torch_zoo_senet.py``; the SE-ResNeXt-101 and SENet-154 in
``tests/test_torch_zoo_senet154.py``), at full depth: each builds the JAX
package's variable tree key for key (``load_jax_variables`` raises on a
key left over on either side or a shape) and gives a finite eval
embedding at 64x32, two images. The SE-ResNeXt's grouped 3x3 convs (32
groups), ``se_resnet50_fc512``'s last stride 1 and 512-d head.
"""
import pytest

from bpbreid_tpu.models import senet as jsenet
from bpbreid_tpu_torch.models import senet as tsenet
from tests.torch_port_helpers import check_zoo_constructor, limit_torch_threads

limit_torch_threads()


@pytest.mark.parametrize('name, width', [
    ('se_resnet50_fc512', 512), ('se_resnet101', 2048),
    ('se_resnet152', 2048), ('se_resnext50_32x4d', 2048)])
def test_senet_constructors(name, width):
    tm = getattr(tsenet, name)(7)
    out = check_zoo_constructor(getattr(jsenet, name)(7), tm, (64, 32))
    assert tuple(out.shape) == (2, width) == (2, tm.feature_dim)
