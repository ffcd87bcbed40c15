"""The IBN-Net ResNets (``models/resnet_ibn.py``), ResNet-mid
(``models/resnetmid.py``) and the fastreid trunks
(``models/resnet_fastreid.py``) of bpbreid_tpu_torch against the JAX
package's, and BPBReID on them.

Seeded JAX variables (BN and instance-norm affines, biases and BN
statistics perturbed) cross over with ``load_jax_variables``. f32 on the
CPU at 64x32 (blocks at 16x8), batch 4:

- blocks and reduced-depth models (one or two blocks a stage), eval and
  train mode: outputs to 1e-4 of their largest magnitude (1e-3 for whole
  models in train mode, where f32 rounding compounds over the train-mode
  batch and instance norms), running statistics after the train-mode
  forward to 1e-4;
- the registry constructors at full depth: the same variables (every key
  and shape of JAX's tree, nothing left over);
- BPBReID on a reduced fastreid IBN + non-local trunk, registered in
  both registries for the test: embeddings and pixel scores to 1e-3, as
  the other BPBReID tests hold them, visibility scores equal; the
  registry's backbones as BPBReID builds them;
- a torchreid file written from the JAX variables (``flax_to_torch``)
  loads key for key, instance norms included, and gives the same
  outputs (1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.models import resnet_fastreid as jfr
from bpbreid_tpu.models import resnet_ibn as jibn
from bpbreid_tpu.models import resnetmid as jmid
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.utils.torch_weights import flax_to_torch
from bpbreid_tpu_torch.models import BACKBONES
from bpbreid_tpu_torch.models import resnet_fastreid as tfr
from bpbreid_tpu_torch.models import resnet_ibn as tibn
from bpbreid_tpu_torch.models import resnetmid as tmid
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.torch_weights import load_torchreid_state_dict
from tests.torch_port_helpers import (assert_close, check_against_jax,
                                      limit_torch_threads, nchw,
                                      seeded_variables, to_np)

limit_torch_threads()

N, H, W = 4, 64, 32


def _images(seed, n=N, h=H, w=W, c=3):
    return (0.5 + np.random.default_rng(seed).standard_normal(
        (n, h, w, c))).astype(np.float32)


def test_ibn_layer_matches_jax_and_counts_its_copy():
    """Half instance norm, half batch norm; the BN half is a strided view
    of the NCHW batch, copied once a call (``copies``)."""
    tm = check_against_jax(jfr.IBNLayer(), tfr.IBNLayer(64),
                           _images(0, N, 16, 8, 64))
    assert tm.copies == 2
    with torch.no_grad():
        tm(torch.ones(1, 64, 2, 2))         # one sample: already contiguous
    assert tm.copies == 2


@pytest.mark.parametrize('sane_nl', [False, True])
def test_non_local_matches_jax(sane_nl):
    """The embedded-gaussian block, with the reference's one inner
    channel and with ``channels // 2``."""
    check_against_jax(jfr.NonLocal(sane_nl=sane_nl),
                      tfr.NonLocal(64, sane_nl), _images(1, N, 8, 4, 64))


def test_ibn_b_bottleneck_matches_jax():
    """The IBN-Net bottleneck with IBN-b's instance norm after the
    residual; 64 -> 4 x 16 channels with the downsample, at 16x8 (IBN-a's
    bn1 is the ``IBNLayer`` above, in the reduced models below)."""
    jm = jibn.IBNBottleneck(16, 1, True, in_after=True)
    tm = tibn.IBNBottleneck(64, 16, 1, True, in_after=True)
    check_against_jax(jm, tm, _images(2, N, 16, 8, 64))


def test_se_layer_matches_jax():
    """fastreid's squeeze and excitation (no registry constructor sets
    ``with_se``)."""
    jm, tm = jfr.SELayer(), tfr.SELayer(64)
    x = _images(8, N, 8, 4, 64)
    variables = seeded_variables(jm, tm, x)
    with torch.no_grad():
        assert_close(tm(nchw(x)), np.transpose(
            np.asarray(jm.apply(variables, x)), (0, 3, 1, 2)), 1e-5)


# reduced depths: one or two blocks a stage
FASTREID_SMALL = dict(with_ibn=True, with_nl=True, layers=(1, 2, 1, 1),
                      non_layers=(0, 2, 1, 0))


@pytest.mark.parametrize('model', ['fastreid_ibn_nl', 'ibn_a_part_based',
                                   'mid_triplet'])
def test_reduced_models_match_jax(model):
    """The fastreid trunk (IBN-a, non-local blocks after both blocks of
    layer2 and the block of layer3, last stride 1), IBN-a's part-based
    map and ResNet-mid (the triplet heads: class scores and the fused
    embedding) at one or two blocks a stage."""
    if model == 'fastreid_ibn_nl':
        jm = jfr.FastReIDResNet(**FASTREID_SMALL)
        tm = tfr.FastReIDResNet(**FASTREID_SMALL)
    elif model.startswith('ibn'):
        variant, loss = model[4], model[6:]
        jm = jibn.ResNetIBN(7, loss, variant, layers=(1, 1, 1, 1))
        tm = tibn.ResNetIBN(7, loss, variant, layers=(1, 1, 1, 1))
    else:
        jm = jmid.ResNetMid(7, 'triplet', layers=(1, 1, 1, 3))
        tm = tmid.ResNetMid(7, 'triplet', layers=(1, 1, 1, 3))
    tm = check_against_jax(jm, tm, _images(3), train_tol=1e-3)
    if model == 'fastreid_ibn_nl':
        assert sum(m.copies for m in tm.modules()
                   if isinstance(m, tfr.IBNLayer)) == 2 * 4


def register_small_fastreid(monkeypatch):
    """The reduced fastreid trunk under one name in both packages'
    registries, for this test only; returns the name."""
    name = 'fastreid_small'
    monkeypatch.setitem(BACKBONES, name, lambda num_classes, **kw:
                        tfr.FastReIDResNet(**FASTREID_SMALL))
    monkeypatch.setitem(jmodels.__dict__['__model_factory'], name,
                        lambda **kw: jfr.FastReIDResNet(**FASTREID_SMALL))
    return name


def test_bpbreid_on_fastreid_matches_jax(monkeypatch):
    """BPBReID (after-pooling reduction) on the reduced fastreid IBN +
    non-local trunk, eval mode. Train mode: the trunk's in
    ``test_reduced_models_match_jax``, BPBReID's in
    ``tests/test_torch_osnet.py`` and ``tests/test_torch_resnet.py``."""
    kw = dict(num_classes=7, parts_num=5, dim_reduce_output=32,
              backbone=register_small_fastreid(monkeypatch))
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
    assert_close(got[3], jnp.transpose(want[3], (0, 3, 1, 2)), 1e-3)


@pytest.mark.parametrize('name', ['fastreid_resnet_ibn_nl', 'resnet50_ibn_a',
                                  'resnet50mid'])
def test_constructors_match_jax_as_bpbreid_backbones(name):
    """The registry constructors at full depth, as BPBReID builds them
    (through the registry, part-based): JAX's variable tree loads key for
    key into the backbone and none is left over on either side
    (``load_jax_variables`` raises otherwise); the map is 2048 channels
    on JAX's grid (last stride 1 for the fastreid trunks, 2 for the
    IBN-Net ResNets and ResNet-mid, as in JAX)."""
    backbone = TBPBreID(num_classes=7, parts_num=5, dim_reduce_output=32,
                        backbone=name).backbone_appearance_feature_extractor
    jm = getattr(jmodels, name)(num_classes=7, loss='part_based')
    seeded_variables(jm, backbone, jnp.zeros((1, H, W, 3)))
    assert backbone.feature_dim == 2048
    with torch.no_grad():
        out = backbone.eval()(nchw(_images(6, 2)))
    grid = (4, 2) if name.startswith('fastreid') else (2, 1)
    assert tuple(out.shape) == (2, 2048) + grid
    assert torch.isfinite(out).all()


def test_fastreid_and_ibn_constructor_options():
    """The other constructors are the same classes with other options."""
    def kinds(model):
        return {type(m).__name__ for m in model.modules()}
    for name, ibn, nl in (('fastreid_resnet', False, False),
                          ('fastreid_resnet_ibn', True, False),
                          ('fastreid_resnet_nl', False, True)):
        model = BACKBONES[name](7, last_stride=2, enable_dim_reduction=True)
        assert ('IBNLayer' in kinds(model)) == ibn
        assert ('NonLocal' in kinds(model)) == nl
        assert model.layer4[0].conv2.stride == 2
        assert [len(getattr(model, 'NL_{}'.format(i), ()))
                for i in range(1, 5)] == ([0, 2, 3, 0] if nl else [0] * 4)
    b = tibn.resnet50_ibn_b(7)
    assert isinstance(b.bn1, tibn.InstanceNorm) and b.layer1[2].IN is not None
    assert 'IBNLayer' not in kinds(b)
    assert isinstance(tibn.resnet50_ibn_a(7).layer3[0].bn1, tfr.IBNLayer)
    assert not isinstance(tibn.resnet50_ibn_a(7).layer4[0].bn1, tfr.IBNLayer)


def test_torchreid_file_of_ibn_model_loads():
    """A torchreid state dict written from the JAX variables of a reduced
    IBN-b ResNet (``flax_to_torch``: instance norms as ``IN.weight`` /
    ``IN.bias`` and the stem's ``bn1.weight`` / ``bn1.bias``) loads into
    the port key for key and gives the outputs of ``load_jax_variables``."""
    jm = jibn.ResNetIBN(7, 'softmax', 'b', layers=(1, 1, 1, 1))
    x = _images(7, 2)
    by_jax = tibn.ResNetIBN(7, 'softmax', 'b', layers=(1, 1, 1, 1))
    variables = seeded_variables(jm, by_jax, x, train=True)
    sd = {k: torch.as_tensor(np.ascontiguousarray(v))
          for k, v in flax_to_torch(variables).items()}
    assert 'layer1.0.IN.weight' in sd and 'bn1.bias' in sd
    by_file = tibn.ResNetIBN(7, 'softmax', 'b', layers=(1, 1, 1, 1))
    matched, discarded = load_torchreid_state_dict(by_file, sd)
    assert not discarded and len(matched) == len(sd)
    with torch.no_grad():
        assert_close(by_file.eval()(nchw(x)), by_jax.eval()(nchw(x)), 1e-6)


def test_resnet50mid_part_based_width_divergence_kept_on_purpose():
    """As a part-based backbone ``resnet50mid`` returns layer4's third
    block's 2048-channel map. JAX's ``ResNetMid.feature_dim``
    (``bpbreid_tpu/models/resnetmid.py`` :28) reports 3072, the width of
    the fused embedding it does not return, which flax's shape inference
    hides; the port's modules need the map's true width (2048). So with a
    ``before_pooling`` reduction JAX's BPBReID reduces 2048 channels to
    2048 (``use_before_reduce`` compares 3072 with 2048) where the port
    keeps the map, and with a reduction to 3072 JAX keeps the 2048-wide
    map where the port reduces to 3072. With the after-pooling reduction
    (every shipped config) the two agree."""
    jm = jmid.resnet50mid(7, loss='part_based')
    x = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), x, train=False))
    assert jm.feature_dim == 3072 and shapes[0].shape[-1] == 2048
    assert 'fc_fusion.0' not in shapes[1]['params']
    assert tmid.resnet50mid(7, loss='part_based').feature_dim == 2048
    assert tmid.resnet50mid(7).feature_dim == 3072
    for out_dim, jax_reduces, port_reduces in ((2048, True, False),
                                               (3072, False, True)):
        kw = dict(num_classes=7, parts_num=5, backbone='resnet50mid',
                  dim_reduce='before_pooling', dim_reduce_output=out_dim)
        assert JBPBreID(**kw).bind({}).use_before_reduce == jax_reduces
        assert TBPBreID(**kw).use_before_reduce == port_reduces
