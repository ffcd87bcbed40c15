"""Train-time augmentation of bpbreid_tpu_torch against bpbreid_tpu
``train_augment``, with the same draws: the test replays the JAX key
splits of ``train_augment`` (flip, crop offsets, colour jitter, erase)
and hands those draws to the port, since torch cannot reproduce
``jax.random``. Images and masks, including ``_mask_composed_chain``
with a crop, a flip and an erase, from native fields at 1/8 of the
image and at full resolution. f32; tolerance 1e-5 (images; the hue
round trip 1e-4) and 1e-5 (masks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.data import augment as jaug
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data import augment as taug
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from tests.torch_port_helpers import to_nhwc, limit_torch_threads

limit_torch_threads()

CJ = dict(cj_brightness=0.2, cj_contrast=0.15, cj_saturation=0.3,
          cj_hue=0.1, cj_p=0.5)


def jax_draws(key, n, h, w, transforms, cj=CJ):
    """The draws ``bpbreid_tpu.data.augment.train_augment`` makes from
    ``key``, as port tensors."""
    r = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())   # noqa: E731
    draws = {'flip': None, 'off': None, 'cj': None, 'erase': None}
    if 'rf' in transforms:
        draws['flip'] = t(jax.random.bernoulli(r[0], 0.5, (n, 1, 1, 1))
                          ).reshape(n)
    if 'rc' in transforms:
        draws['off'] = t(jax.random.randint(r[1], (n, 2), 0, 21)).long()
    if 'cj' in transforms:
        r_apply, r_b, r_c, r_s, r_h = jax.random.split(r[2], 5)
        u = lambda k, x: t(jax.random.uniform(  # noqa: E731
            k, (n,), minval=max(0.0, 1 - x), maxval=1 + x))
        draws['cj'] = {
            'apply': t(jax.random.bernoulli(r_apply, cj['cj_p'], (n,))),
            'brightness': u(r_b, cj['cj_brightness']),
            'contrast': u(r_c, cj['cj_contrast']),
            'saturation': u(r_s, cj['cj_saturation']),
            'hue': t(jax.random.uniform(r_h, (n,), minval=-cj['cj_hue'],
                                        maxval=cj['cj_hue']))}
    if 're' in transforms:
        draws['erase'] = tuple(t(a).long() if a.dtype != bool else t(a)
                               for a in jaug._coarse_dropout_params(
                                   r[3], n, h, w))
    return draws


@pytest.fixture(scope='module')
def mask_kwargs():
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    return mask_chain_kwargs(cfg)


def _batch(seed, n, h, w, mask_scale):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    masks = rng.uniform(size=(n, h // mask_scale, w // mask_scale, 36)) \
        .astype(np.float32)
    return imgs, masks


@pytest.mark.parametrize('transforms', [('rf', 'rc', 're'),
                                        ('rf', 'rc', 'cj', 're'), ('rc',),
                                        ()])
@pytest.mark.parametrize('mask_scale', [8, 1])
def test_train_augment_matches_jax_with_the_same_draws(transforms, mask_scale,
                                                       mask_kwargs):
    n, h, w = 8, 64, 32
    imgs, masks = _batch(0, n, h, w, mask_scale)
    key = jax.random.PRNGKey(3)
    kw = CJ if 'cj' in transforms else {}
    want_i, want_m = jaug.train_augment(
        jnp.asarray(imgs), jnp.asarray(masks), key, transforms=transforms,
        mask_kwargs=mask_kwargs, **kw)
    draws = jax_draws(key, n, h, w, transforms)
    if draws['flip'] is not None:       # the draws exercise both branches
        assert 0 < int(draws['flip'].sum()) < n
    if draws['erase'] is not None:
        assert 0 < int(draws['erase'][0].sum()) < n
    got_i, got_m = taug.train_augment(torch.from_numpy(imgs),
                                      torch.from_numpy(masks), draws,
                                      mask_kwargs=mask_kwargs)
    assert tuple(got_i.shape) == (n, 3, h, w)
    assert tuple(got_m.shape) == (n, 6, h // 4, w // 4)
    np.testing.assert_allclose(to_nhwc(got_i), np.asarray(want_i),
                               atol=1e-4 if 'cj' in transforms else 1e-5)
    np.testing.assert_allclose(to_nhwc(got_m), np.asarray(want_m), atol=1e-5)


def test_helpers_match_jax_helpers():
    """The helpers the JAX version exposes with injected draws:
    ``_pad_crop(off=...)``, ``_coarse_dropout(params=...)``, the hue
    round trip at a zero shift."""
    n, h, w = 4, 12, 8
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    off = rng.integers(0, 21, (n, 2))
    want, _ = jaug._pad_crop(jnp.asarray(imgs), None, None,
                             off=jnp.asarray(off))
    got, _ = taug._pad_crop(torch.from_numpy(imgs), None,
                            torch.from_numpy(off))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    params = (np.array([True, False, True, True]), rng.integers(0, 6, n),
              rng.integers(0, 4, n), rng.integers(1, 6, n),
              rng.integers(1, 4, n))
    want, _ = jaug._coarse_dropout(jnp.asarray(imgs), None, None,
                                   params=tuple(map(jnp.asarray, params)))
    got, _ = taug._coarse_dropout(torch.from_numpy(imgs), None,
                                  tuple(map(torch.from_numpy, params)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shift = np.zeros((n, 1, 1), np.float32)
    np.testing.assert_allclose(
        taug.adjust_hue(torch.from_numpy(imgs), torch.from_numpy(shift)),
        np.asarray(jaug.adjust_hue(jnp.asarray(imgs), jnp.asarray(shift))),
        atol=1e-5)


def test_sample_train_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = taug.sample_train_draws(g, 64, 384, 128, ('rf', 'rc', 'cj', 're'),
                                **CJ)
    assert d['flip'].dtype == torch.bool and d['flip'].shape == (64,)
    assert d['off'].shape == (64, 2)
    assert int(d['off'].min()) >= 0 and int(d['off'].max()) <= 20
    apply, y0, x0, hh, hw = d['erase']
    assert int(hh.min()) >= int(384 * 0.15) and int(hh.max()) <= int(384 * .65)
    assert bool((y0 + hh <= 384).all() and (x0 + hw <= 128).all())
    assert float(d['cj']['brightness'].min()) >= 0.8
    assert float(d['cj']['hue'].abs().max()) <= 0.1
    none = taug.sample_train_draws(g, 4, 8, 8, ())
    assert all(v is None for v in none.values())
