"""Inception-ResNet-V2 (``models/inceptionresnetv2.py``) of
bpbreid_tpu_torch against the JAX package's, at full depth: ten Block35,
twenty Block17 and ten Block8 with their scaled residual sums, BN eps
1e-3, unpadded stem convs and max pools, Mixed-5b's padding-excluding
average pool. Seeded JAX variables (BN affines, biases and statistics
perturbed) cross over with ``load_jax_variables``; f32 on the CPU, batch
4 of images of varied brightness and contrast at 160x96 (a 3x1 map),
JAX jitted: eval to 1e-4 of the largest magnitude, train mode (outputs,
every running statistic after it) to 1e-3 and 1e-4.
"""
from tests.torch_port_helpers import check_zoo_model, limit_torch_threads

limit_torch_threads()


def test_inceptionresnetv2_matches_jax():
    check_zoo_model('inceptionresnetv2', (160, 96))
