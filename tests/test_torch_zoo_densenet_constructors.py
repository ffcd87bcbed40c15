"""The DenseNet constructors of bpbreid_tpu_torch beside ``densenet121``
(``tests/test_torch_zoo_densenet.py``), at full depth: each builds the
JAX package's variable tree key for key (``load_jax_variables`` raises
on a key left over on either side or a shape) and gives a finite eval
embedding of its width at 64x32, two images.
"""
import pytest

from bpbreid_tpu import models as jmodels
from bpbreid_tpu_torch.models import BACKBONES
from tests.torch_port_helpers import check_zoo_constructor, limit_torch_threads

limit_torch_threads()


@pytest.mark.parametrize('name, width', [
    ('densenet169', 1664), ('densenet201', 1920), ('densenet161', 2208),
    ('densenet121_fc512', 512)])
def test_densenet_constructors(name, width):
    tm = BACKBONES[name](7)
    out = check_zoo_constructor(jmodels.build_model(name, 7), tm, (64, 32))
    assert tuple(out.shape) == (2, width) == (2, tm.feature_dim)
