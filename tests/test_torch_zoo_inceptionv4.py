"""InceptionV4 (``models/inceptionv4.py``) of bpbreid_tpu_torch against the
JAX package's, at full depth, and its pools. Seeded JAX variables (BN
affines, biases and statistics perturbed) cross over with
``load_jax_variables``; f32 on the CPU, 8 images of varied brightness and
contrast (``zoo_images``) at 160x96, JAX jitted; eval to 1e-4 of the
largest magnitude, the train-mode output to 3e-3 and the running
statistics after it to 5e-4, not the 1e-3 and 1e-4 of the other modules.
InceptionV4 chains its ~150 train-mode BNs (eps 1e-3) with no residual
path, and each BN grows the relative f32 noise of its input (its input
is ReLU'd, so the batch mean cancels much of each value): JAX's own
train output moves by ~2e-3 of the largest logit, and its running
statistics by ~4e-4, when only the order of the batch is reversed.
The test prints the port's differences beside those moves. The pools:
padding-excluding averages and unpadded max pools at odd sizes, exactly.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn.functional as F

from bpbreid_tpu import models as jmodels
from bpbreid_tpu_torch.models import BACKBONES
from bpbreid_tpu_torch.models.zoo import avg_pool_excl
from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
from tests.torch_port_helpers import (assert_close, check_against_jax,
                                      limit_torch_threads, nchw,
                                      seeded_variables, to_np, to_nhwc,
                                      zoo_images, zoo_init)

limit_torch_threads()

# the package's __init__ binds the name to the constructor
jinception = importlib.import_module('bpbreid_tpu.models.inceptionv4')


@pytest.mark.parametrize('h, w', [(7, 5), (8, 8), (3, 4)])
def test_inception_pools_match_jax(h, w):
    x = zoo_images(h, 2, h, w, 3) - 1.0
    assert_close(to_nhwc(avg_pool_excl(nchw(x))),
                 jinception._avgpool_excl(jnp.asarray(x)), 1e-6)
    assert_close(to_nhwc(F.max_pool2d(nchw(x), 3, 2)),
                 jinception._maxpool_nopad(jnp.asarray(x)), 0)


def _worst(got, want):
    """The largest difference of each pair, relative to its JAX side."""
    return max(float(np.abs(to_np(g) - np.asarray(w)).max())
               / float(np.abs(np.asarray(w)).max()) for g, w in zip(got, want))


def test_inceptionv4_matches_jax():
    jm = jmodels.build_model('inceptionv4', 7, loss='softmax',
                             pretrained=False)
    tm = BACKBONES['inceptionv4'](7, loss='softmax')
    x = zoo_images(0, 8, 160, 96)
    zoo_init(tm, 1)
    variables = seeded_variables(jm, tm, x, initialized=True, train=True)
    _, got, want = check_against_jax(jm, tm, x, train_tol=3e-3,
                                     stats_tol=5e-4, variables=variables,
                                     outputs=True)
    # JAX against itself on the batch reversed, and the port against JAX
    train = jax.jit(functools.partial(jm.apply, train=True,
                                      mutable=['batch_stats']))
    moved, moved_state = train(variables, x[::-1])
    stats = [jax_variables_to_state_dict({'batch_stats': v['batch_stats']})
             for v in (train(variables, x)[1], moved_state)]
    own = tm.state_dict()
    print('inceptionv4 train output: port vs JAX {:.2e}, JAX vs JAX on the '
          'reversed batch {:.2e}; running statistics {:.2e} and {:.2e}'
          .format(_worst([got], [want]), _worst([moved[::-1]], [want]),
                  _worst([own[k] for k in stats[0]], stats[0].values()),
                  _worst(stats[1].values(), stats[0].values())))
