"""The ResNet backbones of bpbreid_tpu_torch against the JAX package's
(``models/resnet.py``), and BPBReID on a ResNet backbone.

Seeded JAX variables (BN statistics and affines perturbed) cross over
with ``load_jax_variables``. f32 on the CPU: the feature maps to 1e-4 of
their largest magnitude in eval mode, and in train mode block by block
(see the test), with the running statistics after the train-mode
forward to 1e-4; BPBReID's embeddings to 1e-3, as the HRNet model tests
hold them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bpbreid_tpu.models import resnet as jresnet
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.models import resnet as tresnet
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.torch_port_helpers import (limit_torch_threads, nchw, to_nhwc,
                                      to_np, randomize_variables)

limit_torch_threads()

N, H, W = 4, 64, 32


def _close(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _images(seed, n=N, h=H, w=W):
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 3)).astype(np.float32)


@pytest.fixture(scope='module', params=['resnet18', 'resnet50'])
def backbones(request):
    name = request.param
    jmodel = getattr(jresnet, name)(7, loss='part_based')
    x = _images(0)
    variables = randomize_variables(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tmodel = load_jax_variables(
        getattr(tresnet, name)(7, loss='part_based'), variables)
    return name, jmodel, variables, tmodel, x


def test_resnet_eval_features_match_jax(backbones):
    _, jmodel, variables, tmodel, x = backbones
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.eval()(nchw(x))
    _close(to_nhwc(got), want, 1e-4)


def test_resnet_train_features_and_stats_match_jax(backbones):
    """Train mode (batch statistics) at 128x64, batch 8, block by block:
    the stem and every residual block of the port, given the JAX model's
    input to it, give JAX's output to 1e-4, and every running statistic
    after the forward matches to 1e-4. The whole f32 map is held to
    1e-4 of the port's own f64 map, and, for resnet18, of JAX's.

    Why not resnet50's whole map against JAX: JAX's own f32 rounding
    (up to a few 1e-5 in one block) compounds over 53 train-mode BNs, so
    its map moves by several 1e-4 of its largest magnitude when the
    batch is merely permuted, at every input size from 64x32 to 256x128.
    The test prints that reading and the port's distance from JAX."""
    name, jmodel, variables, _, _ = backbones
    x = _images(3, 8, 128, 64)
    step = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=['batch_stats', 'intermediates'],
        capture_intermediates=True))
    want, state = step(variables, jnp.asarray(x))
    inter = jax.device_get(state['intermediates'])
    perm = np.roll(np.arange(len(x)), 1)
    permuted = np.asarray(step(variables, jnp.asarray(x[perm]))[0])

    def jout(*path):
        tree = inter
        for p in path:
            tree = tree[p]
        return np.array(tree['__call__'][0])

    # a fresh model: the train-mode forward updates the running statistics
    model = load_jax_variables(getattr(tresnet, name)(7, loss='part_based'),
                               variables).train()
    with torch.no_grad():
        _close(model.bn1(model.conv1(nchw(x))), jnp.transpose(
            jout('bn1'), (0, 3, 1, 2)), 1e-4)
        h = F.max_pool2d(F.relu(nchw(jout('bn1'))), 3, 2, 1)
        for layer in range(1, 5):
            blocks = getattr(model, 'layer{}'.format(layer))
            for b, block in enumerate(blocks):
                want_b = jout('layer{}'.format(layer), str(b))
                _close(to_nhwc(block(h)), want_b, 1e-4)
                h = nchw(want_b)
    stats = jax_variables_to_state_dict(
        {'batch_stats': jax.device_get(state['batch_stats'])})
    own = model.state_dict()
    for key, value in stats.items():
        _close(own[key], value, 1e-4)
    fresh = load_jax_variables(getattr(tresnet, name)(7, loss='part_based'),
                               variables)
    with torch.no_grad():
        got = fresh.train()(nchw(x))
        exact = fresh.double()(nchw(x).double())
    _close(got, exact, 1e-4)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    print('{}: whole train-mode map vs JAX {:.2e}, JAX under a batch '
          'permutation {:.2e} (of the largest magnitude)'.format(
              name, float(np.abs(to_nhwc(got) - want).max()) / scale,
              float(np.abs(permuted[np.argsort(perm)] - want).max())
              / scale))
    if name == 'resnet18':
        _close(to_nhwc(got), want, 1e-4)


@pytest.mark.parametrize('name, loss', [('resnet50_fc512', 'softmax'),
                                        ('resnet18', 'triplet')])
def test_resnet_heads_match_jax(name, loss):
    """The pooled embedding (through ``fc`` for ``resnet50_fc512``) in
    eval mode; in train mode the class scores (and the embedding, for
    the triplet loss) of JAX's shapes."""
    jmodel = getattr(jresnet, name)(7, loss=loss)
    x = jnp.asarray(_images(1, 2))
    variables = randomize_variables(jax.jit(
        lambda k, x: jmodel.init(k, x, train=True))(
            jax.random.PRNGKey(2), x), 3)
    tmodel = load_jax_variables(getattr(tresnet, name)(7, loss=loss),
                                variables)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        _close(tmodel.eval()(nchw(x)), want, 1e-4)
        got = tmodel.train()(nchw(x))
    dim = tmodel.feature_dim
    if loss == 'triplet':
        assert [tuple(t.shape) for t in got] == [(2, 7), (2, dim)]
    else:
        assert tuple(got.shape) == (2, 7) and dim == 512


def test_resnet_registry():
    for name in tresnet.RESNETS:
        assert hasattr(jresnet, name)
    model = tresnet.resnext50_32x4d(3)
    assert model.layer1[0].conv2.groups == 32
    assert model.layer1[0].conv2.weight.shape == (128, 4, 3, 3)
    assert tresnet.resnet34(3).feature_dim == 512
    model = build_model('resnet18', 3, device='cpu')
    assert not model.training and model.feature_dim == 512


@pytest.mark.parametrize('kw', [
    {'backbone': 'resnet18'},
    {'backbone': 'resnet18', 'dim_reduce': 'before_pooling'},
], ids=['after_pooling', 'before_pooling'])
def test_bpbreid_on_resnet_matches_jax(kw):
    kw = dict(kw, num_classes=7, parts_num=5, dim_reduce_output=32)
    jmodel = JBPBreID(**kw)
    x = _images(2)
    variables = randomize_variables(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), None), 4)
    tmodel = load_jax_variables(TBPBreID(**kw), variables)
    assert tmodel.use_before_reduce == (kw.get('dim_reduce')
                                        == 'before_pooling')
    want = jax.jit(lambda v, x: jmodel.apply(v, x, None, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.eval()(nchw(x))
    for key in want[0]:
        _close(got[0][key], want[0][key], 1e-3)
    for key in want[1]:
        np.testing.assert_array_equal(to_np(got[1][key]),
                                      to_np(want[1][key]))
    want, _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, None, train=True, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.train()(nchw(x))
    for key in want[0]:
        _close(got[0][key], want[0][key], 1e-3)
    _close(got[3], jnp.transpose(want[3], (0, 3, 1, 2)), 1e-3)


def test_resnet50_fc512_part_based_width_divergence_kept_on_purpose():
    """As a part-based backbone ``resnet50_fc512`` returns its 2048-channel
    map (no fc head runs). JAX's ``feature_dim`` reports the fc head's 512
    (``bpbreid_tpu/models/resnet.py`` ``ResNet.feature_dim``), which flax's
    shape inference hides; the port's modules need the map's true width,
    so its ``feature_dim`` is 2048 and it builds no ``fc`` there."""
    jmodel = jresnet.resnet50_fc512(7, loss='part_based')
    x = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(lambda: jmodel.init_with_output(
        jax.random.PRNGKey(0), x, train=False))
    assert jmodel.feature_dim == 512 and shapes[0].shape[-1] == 2048
    assert 'fc.0' not in shapes[1]['params']
    tmodel = tresnet.resnet50_fc512(7, loss='part_based')
    assert tmodel.feature_dim == 2048 and not hasattr(tmodel, 'fc')
