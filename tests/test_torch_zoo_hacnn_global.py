"""HACNN's global path (``learn_region=False``: no local branch, the
global embedding alone) of bpbreid_tpu_torch against the JAX package's,
at full depth, 160x64, batch 4 of images of varied brightness and
contrast, seeded variables (BN affines, biases and statistics
perturbed), JAX jitted, the triplet heads: eval (the unnormalized global
embedding) to 1e-4 of the largest magnitude, train mode (the class
scores and the embedding, every running statistic after it) to 1e-3 and
1e-4. The hard attention is built on this path too, as in JAX (its
parameters are in the tree), and runs no spatial transformer. The
registry's ``hacnn`` (both branches): ``tests/test_torch_zoo_hacnn.py``.
"""
from bpbreid_tpu.models.hacnn import HACNN as JHACNN
from bpbreid_tpu_torch.models.hacnn import HACNN as THACNN
from tests.torch_port_helpers import (check_against_jax, limit_torch_threads,
                                      seeded_variables, zoo_images, zoo_init)

limit_torch_threads()


def test_hacnn_global_path_matches_jax():
    jm = JHACNN(7, 'triplet', learn_region=False)
    tm = THACNN(7, 'triplet', learn_region=False)
    assert tm.feature_dim == 512 and not hasattr(tm, 'local_conv1')
    x = zoo_images(9, 4, 160, 64)
    zoo_init(tm, 1)
    variables = seeded_variables(jm, tm, x, initialized=True, train=True)
    _, got, _ = check_against_jax(jm, tm, x, train_tol=1e-3,
                                  variables=variables, outputs=True)
    assert [tuple(t.shape) for t in got] == [(4, 7), (4, 512)]
