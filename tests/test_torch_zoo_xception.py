"""Xception (``models/xception.py``) of bpbreid_tpu_torch against the JAX
package's, at full depth and as a BPBReID backbone: separable convs, the
blocks' Sequential indices, the unpadded stem. Seeded JAX variables (BN
affines, biases and statistics perturbed) cross over with
``load_jax_variables``; f32 on the CPU, images of varied brightness and
contrast at 96x64, JAX jitted: eval to 1e-4 of the largest magnitude,
train mode (outputs, every running statistic after it) to 1e-3 and 1e-4;
BPBReID (after-pooling reduction to 32, five parts) on it, embeddings and
pixel scores to 1e-3, visibility scores equal, the 2048-channel map.
"""
from tests.torch_port_helpers import (check_zoo_bpbreid, check_zoo_model,
                                      limit_torch_threads)

limit_torch_threads()


def test_xception_matches_jax():
    check_zoo_model('xception', (96, 64))


def test_bpbreid_on_xception_matches_jax():
    assert tuple(check_zoo_bpbreid('xception', (96, 64)).shape[1:]) \
        == (2048, 3, 2)
