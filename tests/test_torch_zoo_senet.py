"""SENet (``models/senet.py``) of bpbreid_tpu_torch against the JAX
package's: ``se_resnet50`` at full depth, BPBReID on it, and the
``se_resnet50_fc512`` width and the JAX fault it brings.

Seeded JAX variables (BN affines, biases and statistics perturbed) cross
over with ``load_jax_variables``; f32 on the CPU, batch 4 of images of
varied brightness and contrast at 64x32 (``zoo_images``), JAX jitted:

- ``se_resnet50`` (Caffe-style strides, squeeze-and-excitation, the
  stem's ceil-mode max pool): eval to 1e-4 of the largest magnitude;
  train mode (outputs, every running statistic after it) to 1e-3 and
  1e-4;
- BPBReID on ``se_resnet50``: embeddings and pixel scores to 1e-3,
  visibility scores equal; the map 2048 wide, as ``feature_dim`` says;
- the other constructors: ``tests/test_torch_zoo_senet_constructors.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bpbreid_tpu.models import senet as jsenet
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models import senet as tsenet
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.models.common import init_parameters
from tests.torch_port_helpers import (assert_close, check_zoo_bpbreid,
                                      check_zoo_model, limit_torch_threads,
                                      nchw, to_nhwc, zoo_images)

limit_torch_threads()

HW = (64, 32)


def test_max_pool_ceil_matches_jax():
    """The stem's ceil-mode pool (JAX ``_max_pool_ceil``, -inf padding at
    the bottom and right) at odd and even sizes, on negative values."""
    for h, w in ((7, 5), (8, 6), (16, 9), (3, 3)):
        x = zoo_images(h * w, 2, h, w, 4) - 3.0
        assert_close(to_nhwc(F.max_pool2d(nchw(x), 3, 2, ceil_mode=True)),
                     np.asarray(jsenet._max_pool_ceil(jnp.asarray(x))), 0)


def test_se_resnet50_matches_jax():
    check_zoo_model('se_resnet50', HW)


def test_bpbreid_on_se_resnet50_matches_jax():
    """The backbone through the registry with BPBReID's last stride 1 (as
    JAX's ``_senet`` takes it): a 4x2 map of 2048 at 64x32."""
    fmap = check_zoo_bpbreid('se_resnet50', HW)
    assert tuple(fmap.shape) == (2, 2048, 4, 2)


def test_se_resnet50_fc512_part_based_width_divergence_kept_on_purpose():
    """JAX's ``SENet.feature_dim`` (``bpbreid_tpu/models/senet.py`` :126)
    reports the ``fc`` head's 512 for ``se_resnet50_fc512`` while its
    part-based call returns layer4's 2048-channel map (flax's shape
    inference hides it); the port's ``feature_dim`` is the map's width
    there (512, the head's, for the global model)."""
    jm = jsenet.se_resnet50_fc512(7, loss='part_based')
    shapes = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)), train=False))
    assert jm.feature_dim == 512 and shapes[0].shape[-1] == 2048
    assert 'fc.0' not in shapes[1]['params']
    assert tsenet.se_resnet50_fc512(7, loss='part_based').feature_dim == 2048
    assert tsenet.se_resnet50_fc512(7).feature_dim == 512


def test_se_resnet50_fc512_as_bpbreid_backbone_fault_in_jax():
    """JAX's ``se_resnet50_fc512`` passes ``last_stride=1`` to ``_senet``
    beside the ``last_stride`` BPBReID gives every backbone
    (``bpbreid_tpu/models/bpbreid.py`` :304-309), so JAX's BPBReID on it
    raises TypeError at setup. The port's constructor takes the caller's
    (as ``resnet50_fc512``), and BPBReID builds on the 2048-channel map;
    with a ``before_pooling`` reduction to 512 the port reduces it."""
    kw = dict(num_classes=7, parts_num=5, backbone='se_resnet50_fc512',
              dim_reduce='before_pooling', dim_reduce_output=512)
    with pytest.raises(TypeError, match='last_stride'):
        JBPBreID(**kw).bind({}).use_before_reduce
    model = TBPBreID(**kw)
    init_parameters(model, torch.Generator().manual_seed(0))
    assert model.use_before_reduce
    backbone = model.backbone_appearance_feature_extractor
    assert backbone.feature_dim == 2048 and backbone.layer4[0].conv1.stride \
        == 1
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 3, *HW))
    assert all(torch.isfinite(v).all() for v in out[0].values())
