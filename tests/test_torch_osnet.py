"""The OSNet family of bpbreid_tpu_torch (``models/osnet.py``) and its
instance norm (``models/common.py InstanceNorm``) against the JAX
package's (``models/osnet.py``), and BPBReID on OSNet backbones.

Seeded JAX variables (BN and instance-norm affines, biases and BN
statistics perturbed) cross over with ``load_jax_variables``. f32 on the
CPU, at 64x32 (blocks at 16x8), batch 4:

- the instance norm against flax's ``GroupNorm(num_groups=C)``: 1e-5 of
  the largest output. The two variances differ (the mean of squared
  deviations against E[x^2] - E[x]^2), by f32 rounding of the latter:
  about 1e-7 * E[x^2] / var relative; on these inputs (mean 0.5 beside a
  spread of 1) the outputs differ by a few 1e-7;
- blocks and reduced-depth models, in eval and train mode: outputs to
  1e-4 of their largest magnitude (1e-3 for whole models in train mode,
  where f32 rounding compounds over the train-mode BNs and instance
  norms), the running statistics after the train-mode forward to 1e-4;
- the registry constructors at full depth: the same variables (every
  key and shape of JAX's tree loads, nothing left over);
- BPBReID on a reduced OSNet, registered in both registries for the
  test: embeddings and pixel scores to 1e-3 of their largest magnitude,
  as the other BPBReID tests hold them, visibility scores equal (the
  train-mode BNNecks: see the test); every OSNet of the registry as a
  BPBReID backbone.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.models import osnet as josnet
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models import BACKBONES, build_model
from bpbreid_tpu_torch.models import osnet as tosnet
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.models.common import InstanceNorm, init_parameters
from tests.torch_port_helpers import (assert_close, check_against_jax,
                                      limit_torch_threads, nchw,
                                      seeded_variables, to_nhwc, to_np)

limit_torch_threads()

N, H, W = 4, 64, 32


def _images(seed, n=N, h=H, w=W, c=3):
    return (0.5 + np.random.default_rng(seed).standard_normal(
        (n, h, w, c))).astype(np.float32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_instance_norm_matches_flax_group_norm(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = _images(0, 3, 9, 5, 8)
    jm = fnn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jdtype)
    rng = np.random.default_rng(1)
    variables = {'params': {
        'scale': (1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
        'bias': (0.3 * rng.standard_normal(8)).astype(np.float32)}}
    want = jm.apply(variables, jnp.asarray(x).astype(jdtype))
    tm = InstanceNorm(8, dtype=dtype)
    tm.weight.data = torch.from_numpy(variables['params']['scale'])
    tm.bias.data = torch.from_numpy(variables['params']['bias'])
    got = tm(nchw(x).to(dtype))
    assert got.dtype == dtype and want.dtype == jdtype
    # bf16: both round an f32 result once, so at most one bf16 ulp apart
    assert_close(to_nhwc(got), want,
                 1e-5 if dtype == torch.float32 else 2 ** -7)


def test_osnet_ain_block_matches_jax():
    """One AIN block with the instance norm inside its residual, at the
    shape of the AIN model's first block below (16 -> 32 channels at
    16x8, the 1x1 downsample in the residual): the primitives JAX
    compiles here serve that model, which holds the other block kinds
    with the IBN layout's."""
    jm = josnet.OSBlockAIN(32, in_inside=True)
    tm = tosnet.OSBlockAIN(16, 32, in_inside=True)
    check_against_jax(jm, tm, _images(2, N, 16, 8, 16))


# reduced depths and widths of each layout: one block a stage
SMALL = {
    'classic': dict(blocks=(('os',), ('os',), ('os',)),
                    channels=(16, 32, 48, 64)),
    'ibn': dict(blocks=(('os_in',), ('os',), ('os',)),
                channels=(16, 32, 48, 64), conv1_IN=True),
    'ain': dict(blocks=(('ain_in',), ('ain',), ('ain_in',)),
                channels=(16, 32, 48, 64), conv1_IN=True, ain_layout=True),
}


@pytest.mark.parametrize('layout, loss', [('ibn', 'triplet'),
                                          ('ain', 'softmax')])
def test_osnet_models_match_jax(layout, loss):
    """Reduced OSNets of the IBN layout (the classic one with an
    instance-norm stem and the 'os_in' blocks in its first stage) and the
    AIN layout: the eval embedding, the train-mode class scores (and
    embedding, for the triplet loss) and the running statistics. The
    part-based map: the BPBReID test below."""
    kw = SMALL[layout]
    jm = josnet.OSNet(num_classes=7, loss=loss, **kw)
    tm = tosnet.OSNet(num_classes=7, loss=loss, **kw)
    check_against_jax(jm, tm, _images(3), train_tol=1e-3)
    assert tm.feature_dim == (64 if loss == 'part_based' else 512)


@pytest.mark.parametrize('name', ['osnet_ain_x1_0'])
def test_osnet_constructors_match_jax(name):
    """The registry constructors at full depth have JAX's variables: every
    key and shape of JAX's tree loads, and none is left over on either
    side (``load_jax_variables`` raises otherwise). Their arithmetic is
    the reduced models' above (each layout's names are checked there
    too)."""
    jm = getattr(josnet, name)(num_classes=7, loss='softmax')
    tm = getattr(tosnet, name)(7, loss='softmax')
    seeded_variables(jm, tm, jnp.zeros((1, H, W, 3)), train=True)
    with torch.no_grad():
        assert tuple(tm.eval()(torch.zeros(2, 3, H, W)).shape) == (2, 512)


def register_small_osnet(monkeypatch, layout):
    """A reduced OSNet of ``layout`` under one name in both packages'
    registries, for this test only; returns the name."""
    name = 'osnet_small_' + layout
    monkeypatch.setitem(BACKBONES, name, lambda num_classes, **kw:
                        tosnet._osnet(num_classes=num_classes,
                                      **SMALL[layout], **kw))
    monkeypatch.setitem(jmodels.__dict__['__model_factory'], name,
                        functools.partial(josnet._osnet, **SMALL[layout]))
    return name


NECKS = (('bn_globl', 'globl', 'global_identity_classifier'),
         ('bn_backg', 'backg', 'background_identity_classifier'),
         ('bn_foreg', 'foreg', 'foreground_identity_classifier'),
         ('bn_conct', 'conct', 'concat_parts_identity_classifier'))


def test_bpbreid_on_osnet_matches_jax(monkeypatch):
    """BPBReID on a reduced AIN-layout OSNet (after-pooling reduction),
    eval and train mode, from the port's seeded weights.

    In train mode the BNNecks batch-normalize ``[4, D]`` embeddings,
    ReLU outputs whose variance over 4 samples can be tiny: there the
    neck divides the embeddings' f32 noise by it. So the train-mode
    necks are held on JAX's own embeddings, to 1e-4, and everything
    before them to 1e-3. The test prints how far each of JAX's train-mode
    outputs moves when the batch is merely permuted, beside the port's
    distance from it: the embeddings before the necks 2e-5 to 6e-5 of
    their magnitude either way; after the concat and part necks JAX's
    own 2e-4 and the port's 3e-3, its error landing on features of
    another, smaller variance over the 4 samples."""
    kw = dict(num_classes=7, parts_num=5, dim_reduce_output=32,
              backbone=register_small_osnet(monkeypatch, 'ain'))
    jmodel, tmodel = JBPBreID(**kw), TBPBreID(**kw)
    x = jnp.asarray(_images(5))
    variables = seeded_variables(jmodel, tmodel, x, None, seed=5)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, None, train=False))(
        variables, x)
    with torch.no_grad():
        got = tmodel.eval()(nchw(x))
    for key in want[0]:
        assert_close(got[0][key], want[0][key], 1e-3)
    for key in want[1]:
        np.testing.assert_array_equal(to_np(got[1][key]),
                                      to_np(want[1][key]))
    train = jax.jit(lambda v, x: jmodel.apply(
        v, x, None, train=True, mutable=['batch_stats'])[0])
    want = train(variables, x)
    perm = np.roll(np.arange(len(x)), 1)
    permuted = train(variables, x[perm])
    with torch.no_grad():
        got = tmodel.train()(nchw(x))
        necks = {key: getattr(tmodel, neck)(torch.from_numpy(
            np.asarray(want[0][src])))[0] for key, src, neck in NECKS}
        necks['bn_parts'] = tmodel._parts_identity_classification(
            torch.from_numpy(np.asarray(want[0]['parts'])))[0]
    for key in want[0]:
        if key in necks:
            assert_close(necks[key], want[0][key], 1e-4)
        else:
            assert_close(got[0][key], want[0][key], 1e-3)
    assert_close(got[3], jnp.transpose(want[3], (0, 3, 1, 2)), 1e-3)
    for key in want[0]:
        w = np.asarray(want[0][key])
        scale = float(np.abs(w).max())
        print('train-mode {}: JAX under a batch permutation {:.2e}, the '
              'port {:.2e} (of the largest magnitude)'.format(
                  key, float(np.abs(np.asarray(permuted[0][key])[
                      np.argsort(perm)] - w).max()) / scale,
                  float(np.abs(to_np(got[0][key]) - w).max()) / scale))


@pytest.mark.parametrize('name', ['osnet_x1_0', 'osnet_x0_75', 'osnet_x0_5',
                                  'osnet_ibn_x1_0'])
def test_bpbreid_accepts_osnet_backbones(name):
    """The other OSNets as BPBReID backbones: built through the registry,
    embeddings of the reduced width, the pixel classifier on the map's
    true width."""
    tmodel = TBPBreID(num_classes=7, parts_num=5, dim_reduce_output=32,
                      backbone=name).eval()
    init_parameters(tmodel, torch.Generator().manual_seed(0))
    width = {'osnet_x0_75': 384, 'osnet_x0_5': 256}.get(name, 512)
    assert tmodel.backbone_appearance_feature_extractor.feature_dim == width
    assert tmodel.pixel_classifier.classifier.weight.shape[1] == width
    with torch.no_grad():
        emb = tmodel(nchw(_images(6, 2)))[0]
    assert tuple(emb['parts'].shape) == (2, 5, 32)
    assert all(torch.isfinite(v).all() for v in emb.values())


def test_osnet_part_based_width_divergence_kept_on_purpose(monkeypatch):
    """As a part-based backbone an OSNet below x1_0 returns its
    ``channels[3]``-wide ``conv5`` map (no fc head runs). JAX's
    ``OSNet.feature_dim`` (``bpbreid_tpu/models/osnet.py`` :217) reports
    ``fc_dim`` (512), which flax's shape inference hides; the port's
    modules need the map's true width: 128 for ``osnet_x0_25``, 256 for
    ``osnet_x0_5``, 384 for ``osnet_x0_75``. So JAX's BPBReID, with a
    ``before_pooling`` reduction to 512, skips it (``use_before_reduce``
    compares 512 with 512) and returns the map's width, where the port
    reduces to the 512 asked for. With the after-pooling reduction (every
    shipped config) the two agree: JAX's Dense infers its input width.
    JAX's map widths are traced on a reduced OSNet (a 64-channel map, the
    same ``feature_dim`` code)."""
    for name, width in (('osnet_x0_75', 384), ('osnet_x0_5', 256),
                        ('osnet_x0_25', 128)):
        assert getattr(josnet, name)(7, loss='part_based').feature_dim == 512
        assert getattr(tosnet, name)(7, loss='part_based').feature_dim \
            == width
        assert build_model(name, 7, loss='softmax',
                           device='cpu').feature_dim == 512
    x = jnp.zeros((1, H, W, 3))
    small = josnet.OSNet(7, 'part_based', **SMALL['classic'])
    shapes = jax.eval_shape(lambda: small.init_with_output(
        jax.random.PRNGKey(0), x, train=False))
    assert small.feature_dim == 512 and shapes[0].shape[-1] == 64
    kw = dict(num_classes=7, parts_num=5, dim_reduce='before_pooling',
              dim_reduce_output=512,
              backbone=register_small_osnet(monkeypatch, 'classic'))
    shapes = jax.eval_shape(lambda: JBPBreID(**kw).init_with_output(
        jax.random.PRNGKey(0), x, None))
    assert shapes[0][0]['parts'].shape[-1] == 64
    assert 'before_pooling_dim_reduce' not in shapes[1]['params']
    tmodel = TBPBreID(**kw).eval()
    assert tmodel.use_before_reduce
    init_parameters(tmodel, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert tmodel(torch.zeros(1, 3, H, W))[0]['parts'].shape[-1] == 512
