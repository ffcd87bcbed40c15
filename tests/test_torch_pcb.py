"""PCB stripes, the ``pcb`` and ``bot`` constructors and the dropout
dim-reduce of bpbreid_tpu_torch against bpbreid_tpu.

The stripes model (zero background channel + K horizontal stripes, no
pixel classifier, the materialized map, no multires, no K2) on the
depth-reduced HRNet-W32 and on ResNet-18 at 64x32, f32, with the JAX
variables carried over by ``load_jax_variables``:

- eval mode, every output within 1e-4 (boolean visibility exact), the
  ``[N, 1920, Hf, Wf]`` HRNet map included;
- train mode (batch statistics over a batch of 4), within 1e-3: the
  order of the f32 sums moves a train-mode BN's output more than 1e-4
  at this batch. Measured on these inputs: the port differs from JAX by
  up to 5.7e-4 (on ``bn_conct``), while JAX's own train-mode outputs
  move by up to 2.1e-3 when the batch is permuted (the same math, sums
  in another order);
- the GiLt loss of the PCB config's weights (identity CE on the six
  stripe embeddings only) on the HRNet's train-mode outputs within 1e-5
  relative;
- ``pcb_stripe_masks`` bit-equal to JAX's for K in {1, 4, 6, 8} at odd
  heights.

The JAX variables are the port's seeded weights (perturbed BN and bias
values), in the tree ``jax.eval_shape`` gives: no compiled JAX init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.losses.gilt import GiLtLoss as JGiLtLoss
from bpbreid_tpu.models import build_model as j_build_model
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.ops.masks import identity_masks as j_identity_masks
from bpbreid_tpu.ops.masks import pcb_stripe_masks as j_pcb_stripe_masks
from bpbreid_tpu_torch.constants import PARTS, PIXELS
from bpbreid_tpu_torch.losses.gilt import GiLtLoss
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.models.bpbreid import (AfterPoolingDimReduce,
                                              BPBreID as TBPBreID,
                                              set_dropout_generator)
from bpbreid_tpu_torch.models.common import init_parameters
from bpbreid_tpu_torch.ops.masks import identity_masks, pcb_stripe_masks
from bpbreid_tpu_torch.scripts.main import build_config
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.test_torch_bpbreid import assert_outputs_match
from tests.torch_port_helpers import (SMALL_W32, limit_torch_threads, nchw,
                                      port_variables, randomize_variables,
                                      to_np)

limit_torch_threads()

PCB_YAML = 'configs/bpbreid/pcb_market1501_train.yaml'
N, H, W, K = 4, 64, 32, 6
BACKBONES = {'hrnet32': dict(backbone='hrnet32', backbone_stages=SMALL_W32),
             'resnet18': dict(backbone='resnet18')}


@pytest.mark.parametrize('parts', [1, 4, 6, 8])
@pytest.mark.parametrize('height', [7, 13, 47])
def test_pcb_stripe_masks_match_jax(parts, height):
    got = pcb_stripe_masks(parts, height, 3)
    want = np.asarray(j_pcb_stripe_masks(parts, height, 3))   # [H, W, K]
    assert tuple(got.shape) == (parts, height, 3)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)
    assert got.sum(0).eq(1).all()            # every row in one stripe
    np.testing.assert_array_equal(identity_masks(height, 3)
                                  .permute(1, 2, 0).numpy(),
                                  np.asarray(j_identity_masks(height, 3)))


@pytest.fixture(scope='module', params=sorted(BACKBONES))
def stripes_pair(request):
    kw = dict(num_classes=7, parts_num=K, dim_reduce_output=32,
              horizontal_stripes=True, **BACKBONES[request.param])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, H, W, 3)).astype(np.float32)
    tm = TBPBreID(**kw, use_pallas_pooling=True)
    init_parameters(tm, torch.Generator().manual_seed(0))
    jm = JBPBreID(**kw)
    variables = randomize_variables(
        port_variables(jm, tm, jnp.asarray(x)), 1)
    load_jax_variables(tm, variables)
    return request.param, jm, tm, variables, x


def test_stripes_model_eval_matches_jax(stripes_pair, monkeypatch):
    """Eval mode, with ``use_pallas_pooling`` on: K2 stays off (JAX
    :562-566) and there is no pixel classifier."""
    name, jm, tm, variables, x = stripes_pair
    assert 'pixel_classifier' not in variables['params']
    assert not any(k.startswith('pixel_classifier')
                   for k in tm.state_dict())
    assert not tm.multires

    def refuse(*args):
        raise AssertionError('K2 ran under stripes')
    monkeypatch.setattr('bpbreid_tpu_torch.models.bpbreid.'
                        'fused_attention_pool', refuse)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm.eval()(nchw(x))
    assert got[3] is None
    if name == 'hrnet32':
        assert tuple(got[4].shape) == (N, 1920, H // 4, W // 4)
    assert_outputs_match(want, got, atol=1e-4)
    # a stripe is visible where it has rows at the map's height (a
    # 4-row ResNet map has two empty stripes of six); never the background
    hf = got[5][PARTS].shape[2]
    rows = pcb_stripe_masks(K, hf, 1).sum(dim=(1, 2)) > 0
    assert (to_np(got[1][PARTS]) == rows.numpy()[None]).all()
    assert not to_np(got[1]['backg']).any()


@pytest.mark.parametrize('stripes_pair', ['hrnet32'], indirect=True)
def test_stripes_train_step_loss_matches_jax(stripes_pair):
    """Train mode (batch statistics, binary training visibility) and the
    PCB config's GiLt loss on those outputs."""
    _, jm, tm, variables, x = stripes_pair
    cfg = build_config(config_file=PCB_YAML, makedirs=False)
    weights = cfg.loss.part_based.weights
    assert weights[PARTS]['id'] == 1 and weights[PIXELS]['ce'] == 0
    pids = np.asarray([0, 0, 1, 1], np.int32)
    jgilt = JGiLtLoss(weights, use_visibility_scores=False)

    @jax.jit
    def j_train(variables, x, pids):
        out, _ = jm.apply(variables, x, train=True, mutable=['batch_stats'])
        return out, jgilt(out[0], out[1], out[2], pids)[0]

    want, want_loss = j_train(variables, jnp.asarray(x), jnp.asarray(pids))
    tm.train()
    try:
        with torch.no_grad():
            got = tm(nchw(x))
    finally:
        tm.eval()
    assert_outputs_match(want, got, atol=1e-3)
    loss, _ = GiLtLoss(weights)(got[0], got[1], got[2],
                                torch.from_numpy(pids).long())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize('name', ['pcb', 'bot'])
def test_pcb_bot_constructors_give_jax_keys_and_shapes(name):
    def config(cfg):
        cfg.model.bpbreid.backbone = 'resnet18'
        cfg.model.bpbreid.masks.parts_num = K
        cfg.model.bpbreid.dim_reduce_output = 32
        return cfg
    jcfg = config(j_default_config())
    cfg = config(build_config(makedirs=False))
    jm = j_build_model(name, 7, loss='part_based', config=jcfg)
    tm = build_model(name, 7, config=cfg, device='cpu')
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((2, H, W, 3)))
    want = jax_variables_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), want))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
    # the constructors set the config as JAX's do
    assert cfg.model.bpbreid.learnable_attention_enabled is False
    assert cfg.model.bpbreid.masks.parts_num == (1 if name == 'bot' else K)
    assert tm.parts_num == cfg.model.bpbreid.masks.parts_num
    assert tm.horizontal_stripes and not tm.learnable_attention_enabled


def test_dropout_dim_reduce_eval_exact_and_train_scaled():
    """``after_pooling_with_dropout``: the identity in eval mode (the
    whole model equals the one without dropout, bit for bit); in train
    mode every entry is the undropped one times 2 or 0, about half kept,
    the mask from the given generator (the same seed, the same mask)
    and never from torch's global RNG."""
    kw = dict(num_classes=5, parts_num=3, backbone='resnet18',
              dim_reduce_output=64)
    plain = build_model('bpbreid', 5, device='cpu', seed=2,
                        config=_config(kw, 'after_pooling'))
    drop = build_model('bpbreid', 5, device='cpu', seed=2,
                       config=_config(kw, 'after_pooling_with_dropout'))
    assert set(plain.state_dict()) == set(drop.state_dict())
    drop.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, H, W)).astype(np.float32))
    with torch.inference_mode():
        a, b = plain(x), drop(x)
    for key in a[0]:
        assert torch.equal(a[0][key], b[0][key]), key

    ref = AfterPoolingDimReduce(48, 512)
    init_parameters(ref, torch.Generator().manual_seed(0))
    red = AfterPoolingDimReduce(48, 512, dropout_rate=0.5)
    red.load_state_dict(ref.state_dict())
    assert [type(m).__name__ for m in red.layers] == [
        'Dense', 'FastBatchNorm', 'ReLU', 'GeneratorDropout']
    feats = torch.from_numpy(np.random.default_rng(4).normal(
        size=(64, 48)).astype(np.float32))
    red.train()
    with pytest.raises(RuntimeError, match='generator'):
        red(feats)
    outs = []
    for _ in range(2):
        set_dropout_generator(red, torch.Generator().manual_seed(7))
        outs.append(red(feats).detach())
    want = ref.train()(feats).detach()
    assert torch.equal(outs[0], outs[1])
    kept = outs[0] != 0
    assert torch.equal(outs[0][kept], 2 * want[kept])
    positive = want > 0
    share = float((kept & positive).sum()) / float(positive.sum())
    assert abs(share - 0.5) < 0.05
    state = torch.get_rng_state()
    red(feats)
    assert torch.equal(state, torch.get_rng_state())


def _config(kw, dim_reduce):
    cfg = build_config(makedirs=False)
    cfg.model.bpbreid.backbone = kw['backbone']
    cfg.model.bpbreid.masks.parts_num = kw['parts_num']
    cfg.model.bpbreid.dim_reduce_output = kw['dim_reduce_output']
    cfg.model.bpbreid.dim_reduce = dim_reduce
    return cfg
