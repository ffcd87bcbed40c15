"""DenseNet (``models/densenet.py``) of bpbreid_tpu_torch against the JAX
package's: ``densenet121`` at full depth and the width of
``densenet121_fc512``'s map (BPBReID on ``densenet121``:
``tests/test_torch_zoo_bpbreid_irv2.py``).

Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, batch 4 of images of
varied brightness and contrast at 64x32 (``zoo_images``), JAX jitted:
eval to 1e-4 of the largest magnitude, train mode (outputs, every running
statistic after it) to 1e-3 and 1e-4. The other constructors:
``tests/test_torch_zoo_densenet_constructors.py``.
"""
import jax
import jax.numpy as jnp

from bpbreid_tpu.models import densenet as jdensenet
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models import densenet as tdensenet
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from tests.torch_port_helpers import check_zoo_model, limit_torch_threads

limit_torch_threads()

HW = (64, 32)


def test_densenet121_matches_jax():
    check_zoo_model('densenet121', HW)


def test_densenet121_fc512_part_based_width_divergence_kept_on_purpose():
    """JAX's ``DenseNet.feature_dim`` (``bpbreid_tpu/models/densenet.py``
    :54) reports the ``fc`` head's 512 for ``densenet121_fc512`` while the
    part-based call returns the 1024-channel ``norm5`` map; the port's
    ``feature_dim`` is the map's width there (512 for the global model).
    With a ``before_pooling`` reduction to 512, JAX's BPBReID keeps the
    1024-wide map (``use_before_reduce`` compares 512 with 512) where the
    port reduces it; after pooling (every shipped config) they agree."""
    jm = jdensenet.densenet121_fc512(7, loss='part_based')
    shapes = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)), train=False))
    assert jm.feature_dim == 512 and shapes[0].shape[-1] == 1024
    assert 'fc.0' not in shapes[1]['params']
    assert tdensenet.densenet121_fc512(7, loss='part_based').feature_dim \
        == 1024
    assert tdensenet.densenet121_fc512(7).feature_dim == 512
    kw = dict(num_classes=7, parts_num=5, backbone='densenet121_fc512',
              dim_reduce='before_pooling', dim_reduce_output=512)
    assert not JBPBreID(**kw).bind({}).use_before_reduce
    assert TBPBreID(**kw).use_before_reduce
