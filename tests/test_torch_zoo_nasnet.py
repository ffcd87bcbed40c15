"""NASNet-A Mobile (``models/nasnet.py``) of bpbreid_tpu_torch against the
JAX package's, at full depth (its pools: ``tests/test_torch_zoo_ops.py``).

Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, batch 4 of images of
varied brightness and contrast at 128x64, JAX jitted: eval to 1e-4 of the
largest magnitude, train mode (the class scores after the dropout, which
keeps the entries JAX's kept; every running statistic after it) to 1e-3
and 1e-4.
"""
from tests.torch_port_helpers import check_zoo_model, limit_torch_threads

limit_torch_threads()


def test_nasnetamobile_matches_jax():
    check_zoo_model('nasnetamobile', (128, 64))
