"""The train step's losses, optimizer and learning-rate schedule of
bpbreid_tpu_torch against bpbreid_tpu, on the CPU, in f32.

Tolerances: losses and their gradients 1e-6 absolute (plus 1e-5
relative: the same f32 formulas, summed in another order); parameters
after one and three optimizer steps 1e-6 absolute (Adam's update is
about lr per step, lr = 1e-3 here, so 1e-6 is a thousandth of a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.losses import bpa as jbpa
from bpbreid_tpu.losses import cross_entropy as jce
from bpbreid_tpu.losses import gilt as jgilt
from bpbreid_tpu.losses import triplet as jtriplet
from bpbreid_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu_torch.constants import CONCAT_PARTS, FOREGROUND, GLOBAL, PARTS
from bpbreid_tpu_torch.losses import (BodyPartAttentionLoss, GiLtLoss,
                                      cross_entropy_loss,
                                      init_part_based_triplet_loss)
from bpbreid_tpu_torch.losses.triplet import TripletLoss
from bpbreid_tpu_torch.optim import build_lr_scheduler, build_optimizer
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

TOL = dict(atol=1e-6, rtol=1e-5)
LABELS = np.repeat(np.arange(2), 4)         # 2 identities x 4 instances


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize('mode', ['plain', 'weights', 'valid', 'no_smooth'])
def test_cross_entropy_matches_jax(mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 7)).astype(np.float32)
    t = rng.integers(0, 7, 12)
    kw, tkw = {}, {}
    if mode == 'weights':
        w = rng.uniform(size=12).astype(np.float32)
        kw, tkw = {'weights': jnp.asarray(w)}, {'weights': torch.from_numpy(w)}
    elif mode == 'valid':
        v = rng.uniform(size=12) > 0.4
        kw = {'valid_mask': jnp.asarray(v)}
        tkw = {'valid_mask': torch.from_numpy(v)}
    eps = 0.0 if mode == 'no_smooth' else 0.1
    want, jgrad = jax.value_and_grad(lambda a: jce.cross_entropy_loss(
        a, jnp.asarray(t), eps, **kw))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = cross_entropy_loss(tx, torch.from_numpy(t), eps, **tkw)
    got.backward()
    _close(got, want)
    _close(tx.grad, jgrad)


@pytest.mark.parametrize('loss_type', ['cl', 'fl', 'dl'])
def test_body_part_attention_loss_matches_jax(loss_type):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 6, 4, 6)).astype(np.float32)   # NHWC
    target = rng.integers(0, 6, (2, 6, 4))
    (want, jsum), jgrad = jax.value_and_grad(
        lambda a: jbpa.BodyPartAttentionLoss(loss_type)(
            a, jnp.asarray(target)), has_aux=True)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).permute(0, 3, 1, 2).contiguous() \
        .requires_grad_(True)
    got, summary = BodyPartAttentionLoss(loss_type)(tl,
                                                    torch.from_numpy(target))
    got.backward()
    _close(got, want)
    _close(tl.grad.permute(0, 2, 3, 1), jgrad)
    _close(summary['pixls']['a'], jsum['pixls']['a'])


TRIPLETS = ['part_averaged_triplet_loss', 'part_max_triplet_loss',
            'part_min_triplet_loss', 'part_max_min_triplet_loss',
            'inter_parts_triplet_loss', 'intra_parts_triplet_loss']


def _visibility(kind, rng):
    if kind == 'none':
        return None
    v = rng.uniform(size=(8, 5))
    if kind == 'bool':
        return v > 0.3
    return v.astype(np.float32)


@pytest.mark.parametrize('name', TRIPLETS)
@pytest.mark.parametrize('vis_kind', ['none', 'bool', 'float'])
def test_triplet_losses_match_jax(name, vis_kind):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(8, 5, 16)).astype(np.float32)
    vis = _visibility(vis_kind, rng)
    jloss = jtriplet.init_part_based_triplet_loss(name, margin=0.3)
    tloss = init_part_based_triplet_loss(name, margin=0.3)

    def jfn(e):
        out = jloss(e, jnp.asarray(LABELS),
                    None if vis is None else jnp.asarray(vis))
        return out[0], out[1:]
    (want, jaux), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(emb))
    te = torch.from_numpy(emb).requires_grad_(True)
    got = tloss(te, torch.from_numpy(LABELS),
                None if vis is None else torch.from_numpy(vis))
    got[0].backward()
    _close(got[0], want)
    for g, w in zip(got[1:], jaux):
        _close(g, w)
    _close(te.grad, jgrad)


def test_soft_margin_and_random_variant_match_jax():
    """margin 0 (soft margin) and the random max/min variant, whose
    dropout the port draws from a torch.Generator: the JAX loss gets the
    same keep mask as its visibility."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(8, 5, 16)).astype(np.float32)
    want = jtriplet.PartAveragedTripletLoss(margin=0.0)(
        jnp.asarray(emb), jnp.asarray(LABELS))
    got = init_part_based_triplet_loss('part_averaged_triplet_loss',
                                       margin=0.0)(
        torch.from_numpy(emb), torch.from_numpy(LABELS))
    for g, w in zip(got, want):
        _close(g, w)

    keep = torch.rand((5, 8, 8), generator=torch.Generator().manual_seed(7)) \
        > 0.5
    part_dist = jtriplet.part_based_pairwise_distance_matrix(
        jnp.transpose(jnp.asarray(emb), (1, 0, 2)))
    pairwise = jtriplet.PartMaxMinTripletLoss().combine(
        part_dist, jnp.asarray(keep.numpy()), jnp.asarray(LABELS))
    want = jtriplet.hard_mine_triplet_loss(pairwise, jnp.asarray(LABELS))
    got = init_part_based_triplet_loss('part_random_max_min_triplet_loss')(
        torch.from_numpy(emb), torch.from_numpy(LABELS),
        generator=torch.Generator().manual_seed(7))
    for g, w in zip(got, want):
        _close(g, w)


def test_global_triplet_loss_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    want = jtriplet.TripletLoss(0.3)(jnp.asarray(x), jnp.asarray(LABELS))
    _close(TripletLoss(0.3)(torch.from_numpy(x), torch.from_numpy(LABELS)),
           want)


@pytest.mark.parametrize('use_vis', [False, True])
@pytest.mark.parametrize('binary', [True, False])
def test_gilt_loss_matches_jax(use_vis, binary):
    rng = np.random.default_rng(5)
    n, k, d, c = 8, 5, 16, 7
    emb = {GLOBAL: rng.normal(size=(n, d)), FOREGROUND: rng.normal(size=(n, d)),
           CONCAT_PARTS: rng.normal(size=(n, k * d)),
           PARTS: rng.normal(size=(n, k, d))}
    cls = {GLOBAL: rng.normal(size=(n, c)), FOREGROUND: rng.normal(size=(n, c)),
           CONCAT_PARTS: rng.normal(size=(n, c)),
           PARTS: rng.normal(size=(n, k, c))}
    vis = {key: rng.uniform(size=(n,) if key != PARTS else (n, k))
           for key in emb}
    vis = {key: (v > 0.3) if binary else v.astype(np.float32)
           for key, v in vis.items()}
    emb = {key: v.astype(np.float32) for key, v in emb.items()}
    cls = {key: v.astype(np.float32) for key, v in cls.items()}
    weights = {GLOBAL: {'id': 1., 'tr': 0.5}, FOREGROUND: {'id': 1., 'tr': 0.},
               CONCAT_PARTS: {'id': 0.7, 'tr': 0.}, PARTS: {'id': 0.3, 'tr': 1.}}

    def jfn(e, s):
        return jgilt.GiLtLoss(weights, use_visibility_scores=use_vis)(
            e, {key: jnp.asarray(v) for key, v in vis.items()}, s,
            jnp.asarray(LABELS))
    (want, jsum), (jge, jgs) = jax.value_and_grad(jfn, argnums=(0, 1),
                                                  has_aux=True)(
        {key: jnp.asarray(v) for key, v in emb.items()},
        {key: jnp.asarray(v) for key, v in cls.items()})
    temb = {key: torch.from_numpy(v).requires_grad_(True)
            for key, v in emb.items()}
    tcls = {key: torch.from_numpy(v).requires_grad_(True)
            for key, v in cls.items()}
    got, summary = GiLtLoss(weights, use_visibility_scores=use_vis)(
        temb, {key: torch.from_numpy(v) for key, v in vis.items()}, tcls,
        torch.from_numpy(LABELS))
    got.backward()
    _close(got, want)
    for key in jsum:
        assert set(summary[key]) == set(jsum[key]), key
        for stat in jsum[key]:
            _close(summary[key][stat], jsum[key][stat])
    for key in emb:     # a stream no loss reads gets no gradient
        for t, jg in ((temb[key], jge[key]), (tcls[key], jgs[key])):
            _close(torch.zeros_like(t) if t.grad is None else t.grad, jg)


class _Two(torch.nn.Module):
    def __init__(self, backbone, classifier):
        super().__init__()
        self.backbone = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in backbone.items()})
        self.classifier = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in classifier.items()})


@pytest.mark.parametrize('optim,staged', [('adam', False), ('adam', True),
                                          ('sgd', False)])
def test_optimizer_matches_optax(optim, staged):
    """One and three steps of the port's optimizer (torch.optim) against
    the JAX ``build_optimizer`` (optax: add_decayed_weights ->
    scale_by_adam -> -lr), with weight decay, on the same gradients."""
    rng = np.random.default_rng(6)
    params = {'backbone': {'w': rng.normal(size=(4, 3)).astype(np.float32),
                           'b': rng.normal(size=(3,)).astype(np.float32)},
              'classifier': {'w': rng.normal(size=(3, 2)).astype(np.float32)}}
    kw = dict(optim=optim, lr=1e-3, weight_decay=5e-4, momentum=0.9,
              staged_lr=staged, new_layers=['classifier'], base_lr_mult=0.1)
    jopt = j_build_optimizer(params if staged else None, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    model = _Two(params['backbone'], params['classifier'])
    topt = build_optimizer(model, **kw)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        for group in ('backbone', 'classifier'):
            for name, p in getattr(model, group).items():
                p.grad = torch.from_numpy(grads[group][name])
        topt.step()
        if step in (0, 2):
            for group in ('backbone', 'classifier'):
                for name, p in getattr(model, group).items():
                    np.testing.assert_allclose(
                        p.detach().numpy(), np.asarray(jparams[group][name]),
                        atol=1e-6, rtol=0, err_msg='{}.{} step {}'.format(
                            group, name, step))


@pytest.mark.parametrize('kind', ['single_step', 'multi_step',
                                  'warmup_multi_step', 'cosine'])
def test_lr_schedule_matches_jax(kind):
    kw = dict(lr=3.5e-4, lr_scheduler=kind, stepsize=[40, 70], gamma=0.1,
              max_epoch=120)
    want, got = j_build_lr_scheduler(**kw), build_lr_scheduler(**kw)
    for epoch in range(0, 121, 3):
        assert got(epoch) == pytest.approx(want(epoch), rel=1e-12)
    model = _Two({'w': np.zeros(2, np.float32)}, {'w': np.zeros(2, np.float32)})
    opt = build_optimizer(model, lr=3.5e-4, staged_lr=True,
                          new_layers=['classifier'], base_lr_mult=0.1)
    got.set_in_optimizer(opt, 5)
    assert [g['lr'] for g in opt.param_groups] == pytest.approx(
        [got(5), 0.1 * got(5)])
    radam = build_optimizer(model, optim='radam', lr=3.5e-4, staged_lr=True,
                            new_layers=['classifier'], base_lr_mult=0.1)
    got.set_in_optimizer(radam, 5)
    assert [g['lr'] for g in radam.param_groups] == pytest.approx(
        [got(5), 0.1 * got(5)])
    with pytest.raises(ValueError, match='Unsupported optimizer'):
        build_optimizer(model, optim='adagrad')


def test_staged_lr_schedule_divergence_kept_on_purpose():
    """With ``staged_lr`` the JAX schedule never reaches the base group:
    ``LRSchedule.set_in_opt_state`` does not enter the ``optax.chain``
    around the base group's injected hyperparameters, so the base layers
    keep ``lr * base_lr_mult`` in every epoch. The port scales each group
    by its ``lr_mult``, as torchreid does. lr 1e-3, base_lr_mult 0.1,
    multi_step at epoch 1 with gamma 0.1, read at epoch 1: new group 1e-4
    on both sides; base group 1e-4 in JAX, 1e-5 in the port."""
    kw = dict(lr=1e-3, lr_scheduler='multi_step', stepsize=[1], gamma=0.1)
    params = {'backbone': {'w': np.zeros(2, np.float32)},
              'classifier': {'w': np.zeros(2, np.float32)}}
    opt_kw = dict(optim='adam', lr=1e-3, staged_lr=True,
                  new_layers=['classifier'], base_lr_mult=0.1)
    jopt = j_build_optimizer(params, **opt_kw)
    jstate = j_build_lr_scheduler(**kw).set_in_opt_state(
        jopt.init(jax.tree_util.tree_map(jnp.asarray, params)), 1)
    j_new = jstate.inner_states['new'].inner_state.hyperparams
    j_base = jstate.inner_states['base'].inner_state[0].hyperparams
    assert float(j_new['learning_rate']) == pytest.approx(1e-4)
    assert float(j_base['learning_rate']) == pytest.approx(1e-4)

    model = _Two(params['backbone'], params['classifier'])
    opt = build_optimizer(model, **opt_kw)
    build_lr_scheduler(**kw).set_in_optimizer(opt, 1)
    new, base = opt.param_groups
    assert new['lr'] == pytest.approx(1e-4)
    assert base['lr'] == pytest.approx(1e-5)
