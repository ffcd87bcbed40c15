"""The whole eval + retrieval slice of bpbreid_tpu_torch vs the JAX
engine: seeded uint8 images and 36-channel confidence fields ->
eval_preprocess -> BPBReID (fused-pool path) -> test embeddings ->
normalize -> part-based distance -> CMC/mAP and SSMD. f32, equal mAP and
CMC (1e-6); SSMD 1e-4 (a ratio of the pair distances' mean gap to their
spread, it moves by about 1e-5 with the 1e-6 differences of the two
frameworks' distances)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.engine import ImagePartBasedEngine as JEngine
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.optim import build_optimizer
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_helpers import (SMALL_W32, randomize_variables,
                                      limit_torch_threads)

limit_torch_threads()

KW = dict(num_classes=7, parts_num=5, backbone='hrnet32',
          backbone_stages=SMALL_W32, dim_reduce_output=32,
          use_pallas_pooling=True, multires_pooling=False)


def _batches(rng, base, n_batches, batch, camid0):
    out = []
    for b in range(n_batches):
        idx = b * batch + np.arange(batch)
        pids = idx % len(base)
        imgs = np.clip(base[pids] + rng.integers(-40, 41, base[pids].shape),
                       0, 255).astype(np.uint8)
        valid = np.ones(batch, bool)
        if b == n_batches - 1:
            valid[-2:] = False                   # a padded last batch
        out.append({'image': imgs,
                    'mask': rng.uniform(size=(batch, 8, 4, 36))
                            .astype(np.float32),
                    'pid': pids, 'camid': camid0 + idx % 3, 'valid': valid})
    return out


def test_eval_and_retrieval_slice_matches_jax_engine():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(6, 64, 32, 3))
    query = _batches(rng, base, 2, 8, 0)
    gallery = _batches(rng, base, 3, 8, 3)

    jcfg = j_default_config()
    jcfg.model.bpbreid.masks.preprocess = 'five_v'
    jcfg.test.batches_per_dispatch = 1
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    kw = mask_chain_kwargs(cfg)
    dm = types.SimpleNamespace(transforms=[], norm_mean=cfg.data.norm_mean,
                               norm_std=cfg.data.norm_std,
                               mask_chain_kwargs=lambda: kw)

    jmodel = JBPBreID(**KW)
    variables = randomize_variables(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)),
        jnp.zeros((2, 16, 8, 6))), 0)
    jengine = JEngine(jcfg, dm, jmodel, build_optimizer(optim='adam'),
                      detailed_ranking=False)
    jengine.load_variables(variables)
    j_cmc, j_map, j_ssmd, j_acc = jengine._evaluate(
        0, query_loader=query, gallery_loader=gallery,
        normalize_feature=True)

    tmodel = load_jax_variables(TBPBreID(**KW), variables).eval()
    engine = ImagePartBasedEngine.from_config(cfg, tmodel, kw, device='cpu')
    out = engine.evaluate(query, gallery, normalize_feature=True)

    assert out['distmat'].shape == (14, 22)
    assert 0.0 <= out['pixel_accuracy'] <= 1.0
    assert out['pixel_accuracy'] == pytest.approx(j_acc, abs=1e-6)
    assert out['mAP'] == pytest.approx(j_map, abs=1e-6)
    np.testing.assert_allclose(out['cmc'][:len(j_cmc)], j_cmc, atol=1e-6)
    assert out['ssmd'] == pytest.approx(j_ssmd, abs=1e-4)
