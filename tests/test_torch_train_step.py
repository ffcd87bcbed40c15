"""The whole train step of bpbreid_tpu_torch against the JAX engine:
seeded uint8 images, 36-channel confidence fields at 1/8 resolution and
pids (2 identities x 4 instances) -> augmentation (flip, crop, erase)
with the JAX key's draws injected -> BPBReID in train mode (multires
pooling, HRNet-W32 at full widths with one BasicBlock per branch, 64x32)
-> GiLt + BPA -> backward -> Adam with weight decay. Two steps, in f32,
against ``jax.value_and_grad(engine._loss_fn)`` plus the optax update.

At batch 8 the train-mode gradient is ill-conditioned: with BN over as
few as 16 values per channel (the 2x1 branch at 64x32), the order of the
f32 sums alone moves it. Measured on this model and batch: the JAX
engine's own gradient, with the batch permuted (the same math, sums in
another order), moves by 0.08 % (relative L2 over all parameters) and
by up to 1.8 % of a tensor's largest entry (median over tensors
0.05 %); the port's gradient differs from JAX's by 0.6 %, up to 6.3 %,
median 0.2 %. The tolerances sit above that:

- loss: 1e-5 relative at step 1;
- gradients at step 1: relative L2 over all parameters 4e-2; per tensor
  the largest error 0.3 of that tensor's largest |gradient|, with the
  median over tensors 2e-2. Biases of a Dense or conv before a
  train-mode BN have a zero gradient in exact arithmetic: both sides
  must give below 1e-6 there;
- BN running statistics after step 1: 1e-4 of their scale;
- parameters after step 1: Adam's first update of an entry is
  lr * g / (|g| + eps) with g = grad + wd * p, about lr * sign(g). So
  the parameters of the two frameworks differ by exactly
  lr * |u_port - u_jax| with u = g / (|g| + eps), computed from each
  side's gradient: that to 1e-6 for every entry. It is 2 * lr where the
  signs differ (g within the gradient noise of 0), and at most 2 % of
  the entries may differ by more than 1e-6;
- after step 2 the step-1 differences have moved both the forward and
  the Adam moments: the loss must agree to 1e-2 relative, the BN
  statistics to 2e-2 of their scale, and the parameters entry by entry
  to 4.01 * lr (each Adam update is at most 1.0014 * lr at step 2) with
  the mean difference below 0.25 * lr (measured: 0.06 * lr).

One block per branch, not the two of ``SMALL_W32``: tracing the JAX
step is most of this file's time, and it scales with the blocks."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.data.augment import train_augment as j_train_augment
from bpbreid_tpu.engine import ImagePartBasedEngine as JEngine
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data import augment as taug
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from bpbreid_tpu_torch.engine import part_based
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.models.common import init_parameters
from bpbreid_tpu_torch.optim import build_optimizer
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.test_torch_train_augment import jax_draws
from tests.torch_port_helpers import (SMALL_W32, randomize_variables,
                                      limit_torch_threads)

limit_torch_threads()

ONE_BLOCK = {stage: (mods, branches, (1,) * branches, channels)
             for stage, (mods, branches, _, channels) in SMALL_W32.items()}
KW = dict(num_classes=7, parts_num=5, backbone='hrnet32',
          backbone_stages=ONE_BLOCK, dim_reduce_output=32)
TRANSFORMS = ('rf', 'rc', 're')
LR, WD = 3.5e-4, 5e-4
N, H, W = 8, 64, 32


def _batches(steps):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(2, H, W, 3))
    pids = np.repeat(np.arange(2), 4)
    return [{'image': np.clip(base[pids] + rng.integers(-30, 31, (N, H, W, 3)),
                              0, 255).astype(np.uint8),
             'mask': rng.uniform(size=(N, H // 8, W // 8, 36))
                     .astype(np.float32),
             'pid': pids} for _ in range(steps)]


@pytest.fixture(scope='module')
def two_steps():
    jcfg = j_default_config()
    jcfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.data.transforms = list(TRANSFORMS)
    kw = mask_chain_kwargs(cfg)
    dm = types.SimpleNamespace(transforms=list(TRANSFORMS),
                               norm_mean=cfg.data.norm_mean,
                               norm_std=cfg.data.norm_std,
                               mask_chain_kwargs=lambda: kw)
    jmodel = JBPBreID(**KW)
    variables = randomize_variables(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)),
        jnp.zeros((2, H // 4, W // 4, 6))), 2)
    jopt = j_build_optimizer(optim='adam', lr=LR, weight_decay=WD)
    jengine = JEngine(jcfg, dm, jmodel, jopt)
    state = jengine.load_variables(variables)

    @jax.jit
    def j_step(params, batch_stats, opt_state, imgs_u8, raw, pids, aug_rng,
               model_rng):
        imgs, masks = j_train_augment(imgs_u8, raw, aug_rng,
                                      transforms=TRANSFORMS, mask_kwargs=kw)
        (loss, (new_bs, _)), grads = jax.value_and_grad(
            jengine._loss_fn, has_aux=True)(params, batch_stats, imgs, masks,
                                            pids, model_rng)
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return loss, grads, params, new_bs, opt_state

    tmodel = load_jax_variables(TBPBreID(**KW), variables)
    engine = ImagePartBasedEngine.from_config(
        cfg, tmodel, kw, device='cpu',
        optimizer=build_optimizer(tmodel, optim='adam', lr=LR,
                                  weight_decay=WD))

    params, bs, opt_state = state.params, state.batch_stats, state.opt_state
    rng = jax.random.PRNGKey(5)
    steps = []
    for batch in _batches(2):
        before = {k: v.detach().clone()
                  for k, v in tmodel.named_parameters()}
        rng, aug_rng, model_rng = jax.random.split(rng, 3)
        loss, grads, params, bs, opt_state = j_step(
            params, bs, opt_state, jnp.asarray(batch['image']),
            jnp.asarray(batch['mask']), jnp.asarray(batch['pid']), aug_rng,
            model_rng)
        t_loss, _ = engine.forward_backward(
            batch, draws=jax_draws(aug_rng, N, H, W, TRANSFORMS))
        steps.append({
            'loss': (float(t_loss), float(loss)),
            'grads': ({k: v.grad.clone() for k, v in
                       tmodel.named_parameters()},
                      jax_variables_to_state_dict(
                          {'params': jax.device_get(grads)})),
            'params': ({k: v.detach().clone() for k, v in
                        tmodel.state_dict().items()},
                       jax_variables_to_state_dict(jax.device_get(
                           {'params': params, 'batch_stats': bs}))),
            'before': before})
    return steps


def _zero_in_exact_arithmetic(key):
    return key.endswith('_after_pooling_dim_reduce.layers.0.bias')


def test_loss_matches(two_steps):
    (got1, want1), (got2, want2) = (st['loss'] for st in two_steps)
    assert np.isfinite(got1) and np.isfinite(got2)
    assert got1 == pytest.approx(want1, rel=1e-5)
    assert got2 == pytest.approx(want2, rel=1e-2)


def test_gradients_match(two_steps):
    got, want = two_steps[0]['grads']
    assert set(got) == set(want)
    rel, diffs, norms = [], [], []
    for key, g in want.items():
        gp = got[key].numpy()
        if _zero_in_exact_arithmetic(key):
            assert np.abs(g).max() < 1e-6 and np.abs(gp).max() < 1e-6, key
            continue
        scale = np.abs(g).max()
        err = np.abs(gp - g).max()
        assert err <= 0.3 * scale + 1e-9, (key, err, scale)
        rel.append(err / max(scale, 1e-30))
        diffs.append(np.sum((gp - g) ** 2))
        norms.append(np.sum(g.astype(np.float64) ** 2))
    assert np.median(rel) <= 2e-2, np.median(rel)
    assert np.sqrt(np.sum(diffs) / np.sum(norms)) <= 4e-2


def _split(got, want):
    for key, w in want.items():
        yield key, got[key].numpy(), w


def test_params_and_bn_statistics_match(two_steps):
    step = two_steps[0]
    g_port, g_jax = step['grads']
    flipped = total = 0
    for key, got, want in _split(*step['params']):
        diff = np.abs(got - want)
        if key.endswith(('running_mean', 'running_var')):
            assert diff.max() <= 1e-4 * (1 + np.abs(want).max()), key
            continue
        p0 = step['before'][key].numpy()
        g_j = g_jax[key] + WD * p0
        g_p = g_port[key].numpy() + WD * p0
        predicted = LR * np.abs(g_p / (np.abs(g_p) + 1e-8)
                                - g_j / (np.abs(g_j) + 1e-8))
        assert np.abs(diff - predicted).max() <= 1e-6, key
        flipped += int((diff > 1e-6).sum())
        total += diff.size
    assert flipped <= 0.02 * total, (flipped, total)

    mean_diff = []
    for key, got, want in _split(*two_steps[1]['params']):
        diff = np.abs(got - want)
        if key.endswith(('running_mean', 'running_var')):
            assert diff.max() <= 2e-2 * (1 + np.abs(want).max()), key
            continue
        assert diff.max() <= 4.01 * LR, key
        mean_diff.append((diff.sum(), diff.size))
    assert sum(d for d, _ in mean_diff) / sum(n for _, n in mean_diff) \
        <= 0.25 * LR


def test_freeze_base_trains_open_layers_only():
    """While the base is frozen only ``open_layers`` get gradients; the
    rest get zeros, so Adam still applies weight decay to them, as the
    JAX step does (it zeroes the gradients before the optax update)."""
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    tmodel = TBPBreID(**KW)
    init_parameters(tmodel, torch.Generator().manual_seed(0))
    engine = ImagePartBasedEngine.from_config(
        cfg, tmodel, mask_chain_kwargs(cfg), device='cpu',
        optimizer=build_optimizer(tmodel, lr=LR, weight_decay=WD))
    engine.set_freeze_base(True)
    before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    loss, summary = engine.forward_backward(_batches(1)[0])
    assert torch.isfinite(loss)
    for name, p in tmodel.named_parameters():
        if 'classifier' in name:
            continue
        assert not p.grad.any(), name
        # weight decay alone: Adam's first step is lr * g / (|g| + eps)
        # with g = wd * p
        g = WD * before[name]
        torch.testing.assert_close(
            p.detach(), before[name] - LR * g / (g.abs() + 1e-8),
            atol=1e-7, rtol=0, msg=name)
    assert tmodel.global_identity_classifier.classifier.weight.grad.any()


def test_eval_step_then_train_step_on_one_engine():
    """Constants cached by an eval step (under inference mode) are
    usable by a later train step, whose autograd saves them."""
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.data.transforms = list(TRANSFORMS)
    tmodel = TBPBreID(**KW)
    init_parameters(tmodel, torch.Generator().manual_seed(1))
    engine = ImagePartBasedEngine.from_config(
        cfg, tmodel, mask_chain_kwargs(cfg), device='cpu',
        optimizer=build_optimizer(tmodel, lr=LR, weight_decay=WD))
    batch = _batches(1)[0]
    feats = engine.eval_step(torch.from_numpy(batch['image']),
                             torch.from_numpy(batch['mask']))[0]
    loss, _ = engine.forward_backward(batch)
    assert torch.isfinite(loss)
    again = engine.eval_step(torch.from_numpy(batch['image']),
                             torch.from_numpy(batch['mask']))[0]
    assert again.shape == feats.shape and not tmodel.training


@pytest.mark.parametrize('segmentation', ['none', 'soft'])
def test_eval_step_feature_grid_masks_match_full_resolution(monkeypatch,
                                                            segmentation):
    """``eval_step`` on masks built at the feature grid gives the pixel
    accuracy (and the features, which read the masks only under target
    segmentation) of the full-resolution mask chain."""
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    tmodel = TBPBreID(test_use_target_segmentation=segmentation, **KW)
    init_parameters(tmodel, torch.Generator().manual_seed(2))
    kw = mask_chain_kwargs(cfg)
    engine = ImagePartBasedEngine.from_config(cfg, tmodel, kw, device='cpu')
    batch = _batches(1)[0]
    imgs = torch.from_numpy(batch['image'])
    fields = torch.from_numpy(batch['mask'])
    grid = engine.eval_step(imgs, fields)

    def full_resolution(imgs_u8, masks, mask_kwargs=None, **norm):
        imgs_out, _ = taug.eval_preprocess(imgs_u8, None, **norm)
        full = taug._masks_to_image_grid(masks.float().permute(0, 3, 1, 2),
                                         H, W)
        return imgs_out, taug.mask_chain(full, **mask_kwargs)
    monkeypatch.setattr(part_based, 'eval_preprocess', full_resolution)
    full = engine.eval_step(imgs, fields)
    features, visibility, _pm, _pix, masks, pxl_correct, pxl_total = grid
    torch.testing.assert_close(masks, full[4], atol=1e-5, rtol=0)
    assert torch.equal(pxl_total, full[6]) and pxl_total.sum() > 0
    assert torch.equal(pxl_correct, full[5]) and pxl_correct.sum() > 0
    assert torch.equal(visibility, full[1])
    if segmentation == 'none':
        assert torch.equal(features, full[0])
    else:
        torch.testing.assert_close(features, full[0], atol=1e-5, rtol=1e-5)
