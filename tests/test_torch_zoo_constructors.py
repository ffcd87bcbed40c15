"""The constructors of MobileNetV2, ShuffleNetV2 and SqueezeNet in
bpbreid_tpu_torch beside their first (``tests/test_torch_zoo_mobile.py``;
``squeezenet1_0`` here), at full depth: each builds the JAX package's
variable tree key for key (``load_jax_variables`` raises on a key left
over on either side or a shape) and gives a finite eval embedding of its
width at 64x32, two images. ``squeezenet1_0`` (Fire modules, ceil-mode
max pools, no batch norm) against JAX's, eval to 1e-4 and train mode to
1e-3 (``tests/test_torch_zoo_mobile.py``'s check).
"""
import pytest

from bpbreid_tpu import models as jmodels
from bpbreid_tpu_torch.models import BACKBONES
from tests.torch_port_helpers import (check_zoo_constructor, check_zoo_model,
                                      limit_torch_threads)

limit_torch_threads()


@pytest.mark.parametrize('name, width', [
    ('mobilenetv2_x1_4', 1792),
    ('shufflenet_v2_x1_0', 1024), ('shufflenet_v2_x1_5', 1024),
    ('shufflenet_v2_x2_0', 2048), ('squeezenet1_1', 512),
    ('squeezenet1_0_fc512', 512)])
def test_zoo_constructors(name, width):
    tm = BACKBONES[name](7)
    out = check_zoo_constructor(jmodels.build_model(name, 7), tm, (64, 32))
    assert tuple(out.shape) == (2, width) == (2, tm.feature_dim)


def test_squeezenet1_0_matches_jax():
    check_zoo_model('squeezenet1_0', (64, 32))
