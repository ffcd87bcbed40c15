"""BPBReID (after-pooling reduction to 32, five parts) on ``inceptionv4``
(1536 channels, 3x1 at 160x96) and ``mlfn`` (2048, 2x1 at 64x32) of
bpbreid_tpu_torch against the JAX package's, through both registries.
Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, two images of varied
brightness and contrast, eval mode, JAX jitted: embeddings and pixel
scores to 1e-3, visibility scores equal; the backbone's ``feature_dim``
is its map's width (MLFN's differs from JAX's,
``tests/test_torch_zoo_mlfn_mudeep.py``). (The zoo's BPBReID tests are
split over ``tests/test_torch_zoo_bpbreid*.py`` to keep each file
short.)
"""
import pytest

from tests.torch_port_helpers import check_zoo_bpbreid, limit_torch_threads

limit_torch_threads()


@pytest.mark.parametrize('name, hw, shape', [
    ('inceptionv4', (160, 96), (1536, 3, 1)),
    ('mlfn', (64, 32), (2048, 2, 1))])
def test_bpbreid_on_deep_backbones_matches_jax(name, hw, shape):
    assert tuple(check_zoo_bpbreid(name, hw).shape[1:]) == shape
