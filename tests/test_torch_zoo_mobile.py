"""The light models of the zoo in bpbreid_tpu_torch against the JAX
package's, each first constructor at full depth: ``mobilenetv2_x1_0``
(depthwise convs, ReLU6), ``shufflenet`` (grouped 1x1 convs, channel
shuffle, the stride-2 blocks' padding-counting average pool),
and ``shufflenet_v2_x0_5`` (channel split and shuffle); ``squeezenet1_0``
is in ``tests/test_torch_zoo_constructors.py``.

Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, batch 4 of images of
varied brightness and contrast at 64x32 (``zoo_images``), JAX jitted:
eval to 1e-4 of the largest magnitude, train mode (outputs, every running
statistic after it) to 1e-3 and 1e-4. Their other constructors:
``tests/test_torch_zoo_constructors.py``; BPBReID on them:
``tests/test_torch_zoo_bpbreid.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from bpbreid_tpu.models.shufflenetv2 import \
    channel_shuffle as jax_channel_shuffle
from bpbreid_tpu_torch.models.zoo import channel_shuffle
from tests.torch_port_helpers import (check_zoo_model, limit_torch_threads,
                                      nchw, to_nhwc, zoo_images)

limit_torch_threads()


@pytest.mark.parametrize('name', ['mobilenetv2_x1_0', 'shufflenet',
                                  'shufflenet_v2_x0_5'])
def test_first_constructors_match_jax(name):
    check_zoo_model(name, (64, 32))


@pytest.mark.parametrize('groups, channels', [(2, 6), (3, 60), (3, 9)])
def test_channel_shuffle_matches_jax(groups, channels):
    x = zoo_images(groups, 2, 3, 5, channels)
    np.testing.assert_array_equal(
        to_nhwc(channel_shuffle(nchw(x), groups)),
        np.asarray(jax_channel_shuffle(jnp.asarray(x), groups)))
