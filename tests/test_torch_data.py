"""bpbreid_tpu_torch mask grouping, background, mask chain and
eval_preprocess vs bpbreid_tpu.

Tolerances: the grouping and background steps are elementwise and match
to 1e-6; the image-grid resize of the confidence fields matches
jax.image.resize 'linear' to 1e-5 when upsampling (the case the data
gives: fields at 1/8 of the image grid). When downsampling, both apply
a triangle (antialiasing) filter and agree to 5e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.data import augment as jaug
from bpbreid_tpu.ops import masks as jmasks
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data import augment as taug
from bpbreid_tpu_torch.ops import masks as tmasks
from tests.torch_port_helpers import nchw, to_nhwc


def _fields(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_grouping_tables_are_copies():
    assert sorted(tmasks.GROUPING_STRATEGIES) == \
        sorted(jmasks.GROUPING_STRATEGIES)
    for name, spec in jmasks.GROUPING_STRATEGIES.items():
        np.testing.assert_array_equal(tmasks.grouping_matrix(name),
                                      spec.matrix)
        assert tmasks.get_grouping(name).parts_names == spec.parts_names
    assert tmasks.get_grouping('five_v').parts_num == 5


@pytest.mark.parametrize('name', ['five_v', 'six_no', 'eight'])
def test_group_masks_matches_jax(name):
    m = _fields((2, 12, 4, 36), 0) * 1.3
    spec = jmasks.get_grouping(name)
    want = jmasks.group_masks(jnp.asarray(m), spec.matrix, spec.combine)
    got = tmasks.group_masks(nchw(m), spec.matrix, spec.combine)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize('strategy,weight', [('sum', 0.0), ('threshold', 15.0),
                                             ('diff_from_max', 0.0),
                                             ('threshold', 0.0)])
def test_add_background_mask_matches_jax(strategy, weight):
    m = _fields((2, 6, 4, 5), 1)
    want = jmasks.add_background_mask(jnp.asarray(m), strategy, weight, 0.5)
    got = tmasks.add_background_mask(nchw(m), strategy, weight, 0.5)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6)


def test_compute_parts_num_and_names_five_v():
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    jcfg = j_default_config()
    jcfg.model.bpbreid.masks.preprocess = 'five_v'
    tmasks.compute_parts_num_and_names(cfg)
    jmasks.compute_parts_num_and_names(jcfg)
    assert cfg.model.bpbreid.masks.parts_num == 5
    assert cfg.model.bpbreid.masks.parts_names == \
        jcfg.model.bpbreid.masks.parts_names


def _mask_kwargs(preprocess):
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = preprocess
    return taug.mask_chain_kwargs(cfg)


@pytest.mark.parametrize('preprocess', ['five_v', 'bs_fu_bb', 'six_no'])
def test_eval_preprocess_upsampling_matches_jax(preprocess):
    """uint8 images + 1/8-grid fields -> normalized NCHW images and
    [N, K+1, H/4, W/4] masks, as the JAX pipeline."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, size=(2, 64, 32, 3)).astype(np.uint8)
    fields = _fields((2, 8, 4, 36), 3)
    kw = _mask_kwargs(preprocess)
    want_i, want_m = jaug.eval_preprocess(jnp.asarray(imgs),
                                          jnp.asarray(fields),
                                          mask_kwargs=kw)
    got_i, got_m = taug.eval_preprocess(torch.from_numpy(imgs),
                                        torch.from_numpy(fields),
                                        mask_kwargs=kw)
    assert tuple(got_i.shape) == (2, 3, 64, 32)
    np.testing.assert_allclose(to_nhwc(got_i), np.asarray(want_i), atol=1e-6)
    assert tuple(got_m.shape) == (2, want_m.shape[-1], 16, 8)
    np.testing.assert_allclose(to_nhwc(got_m), np.asarray(want_m), atol=1e-5)


def test_masks_to_image_grid_identity_and_downsampling():
    fields = _fields((2, 16, 10, 3), 4)
    same = taug._masks_to_image_grid(nchw(fields), 16, 10)
    np.testing.assert_array_equal(to_nhwc(same), fields)
    want = jaug._masks_to_image_grid(jnp.asarray(fields), 8, 4)
    got = taug._masks_to_image_grid(nchw(fields), 8, 4)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=5e-2)


def test_eval_preprocess_without_masks():
    imgs = np.full((1, 8, 4, 3), 255, np.uint8)
    got_i, got_m = taug.eval_preprocess(torch.from_numpy(imgs))
    want_i, _ = jaug.eval_preprocess(jnp.asarray(imgs))
    assert got_m is None
    np.testing.assert_allclose(to_nhwc(got_i), np.asarray(want_i), atol=1e-6)
