"""BPBReID (after-pooling reduction to 32, five parts) on the light zoo
backbones of bpbreid_tpu_torch against the JAX package's, through both
registries: ``mobilenetv2_x1_0`` (1280 channels), ``shufflenet`` (960,
no multiple of 512), ``shufflenet_v2_x0_5`` (1024) and ``squeezenet1_0``
(512). Seeded JAX variables (BN affines, biases and statistics
perturbed) cross over with ``load_jax_variables``; f32 on the CPU, two
images of varied brightness and contrast at 64x32, eval mode, JAX
jitted: embeddings and pixel scores to 1e-3, visibility scores equal;
each backbone's ``feature_dim`` is its map's width. The other backbones'
BPBReID tests are in their modules' test files.
"""
import pytest

from tests.torch_port_helpers import check_zoo_bpbreid, limit_torch_threads

limit_torch_threads()


@pytest.mark.parametrize('name, hw, width', [
    ('mobilenetv2_x1_0', (64, 32), 1280), ('shufflenet', (64, 32), 960),
    ('shufflenet_v2_x0_5', (64, 32), 1024), ('squeezenet1_0', (64, 32), 512)])
def test_bpbreid_on_light_backbones_matches_jax(name, hw, width):
    assert check_zoo_bpbreid(name, hw).shape[1] == width
