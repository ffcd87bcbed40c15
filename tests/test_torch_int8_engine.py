"""``test.int8`` through the engine of bpbreid_tpu_torch, against the JAX
package's engine.

A BPBReID on resnet18 at 64x32 in f32 with the serving pooling (fused,
multires off): its shared blocks carry the int8 graph (the stem is a
float ``nn.Conv`` in JAX, so it is in the port). The same seeded weights
in both packages; each calibrates on its own, on the first
``int8_calib_batches`` query batches at the 99.9th percentile: the
ranges are held within 1e-5 of each buffer's largest value. The features
are then compared on JAX's ranges, carried into the port, and on weights
whose batch norms normalize exactly in f32 (``exact_bn_variables``; why:
tests/test_torch_int8_model.py): the mAP within 1e-3 of JAX's and the
rank-1 equal. The extractor and the CLI: tests/test_torch_int8_tools.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.engine import ImagePartBasedEngine as JEngine
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.optim import build_optimizer
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.models import common as tcommon
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.weights import _walk, load_jax_variables
from tests.torch_port_helpers import (exact_bn_variables, limit_torch_threads,
                                      port_variables)

limit_torch_threads()

KW = dict(num_classes=7, parts_num=5, backbone='resnet18',
          dim_reduce_output=32, use_pallas_pooling=True,
          multires_pooling=False)


def _batches(rng, base, n_batches, batch, camid0):
    out = []
    for b in range(n_batches):
        idx = b * batch + np.arange(batch)
        pids = idx % len(base)
        imgs = np.clip(base[pids] + rng.integers(-40, 41, base[pids].shape),
                       0, 255).astype(np.uint8)
        out.append({'image': imgs,
                    'mask': rng.uniform(size=(batch, 8, 4, 36))
                            .astype(np.float32),
                    'pid': pids, 'camid': camid0 + idx % 3,
                    'valid': np.ones(batch, bool)})
    return out


def _configs():
    out = []
    for cfg in (j_default_config(), get_default_config()):
        cfg.data.height, cfg.data.width = 64, 32
        cfg.model.bpbreid.masks.preprocess = 'five_v'
        cfg.test.int8 = True
        cfg.test.int8_calib_batches = 2
        cfg.test.batches_per_dispatch = 1
        out.append(cfg)
    return out


@pytest.fixture(scope='module')
def variables():
    """JAX variables of a seeded port model, its batch norms exact."""
    tmodel = TBPBreID(**KW)
    tcommon.init_parameters(tmodel, torch.Generator().manual_seed(0))
    return exact_bn_variables(port_variables(
        JBPBreID(**KW), tmodel, jnp.zeros((2, 64, 32, 3)),
        jnp.zeros((2, 16, 8, 6))), 0)


def _assert_ranges_match(model, quant):
    for path, a in _walk(quant):
        owner = model.get_submodule('.'.join(path[:-1]))
        got = owner._buffers[path[-1]].numpy()
        err = np.abs(got - a).max() / np.abs(a).max()
        assert err <= 1e-5, (path, err)


def _port_model(variables):
    return load_jax_variables(TBPBreID(**KW), variables).eval()


def test_int8_engine_evaluate_matches_jax_engine(variables):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(6, 64, 32, 3))
    query = _batches(rng, base, 3, 8, 0)
    gallery = _batches(rng, base, 3, 8, 3)
    jcfg, cfg = _configs()
    kw = mask_chain_kwargs(cfg)
    dm = types.SimpleNamespace(transforms=[], norm_mean=cfg.data.norm_mean,
                               norm_std=cfg.data.norm_std,
                               mask_chain_kwargs=lambda: kw)
    jmodel = JBPBreID(**KW)
    jengine = JEngine(jcfg, dm, jmodel, build_optimizer(optim='adam'),
                      detailed_ranking=False)
    jengine.load_variables(variables)
    j_cmc, j_map, _, _ = jengine._evaluate(
        0, query_loader=query, gallery_loader=gallery,
        normalize_feature=True)
    quant = jax.device_get(jengine._quant_coll)
    engine = ImagePartBasedEngine.from_config(cfg, _port_model(variables),
                                              kw, device='cpu')
    engine.calibrate_int8(query, 2, 99.9)
    _assert_ranges_match(engine.model, quant)
    load_jax_variables(engine.model, {**variables, 'quant': quant})
    out = engine.evaluate(query, gallery, normalize_feature=True)
    assert engine.int8_calibrated
    print('int8 engine: mAP port {} JAX {}; rank-1 port {} JAX {}'.format(
        out['mAP'], j_map, out['cmc'][0], j_cmc[0]))
    assert out['mAP'] == pytest.approx(j_map, abs=1e-3)
    assert out['cmc'][0] == j_cmc[0]
    # int8 was on: the float step gives other features
    imgs = torch.as_tensor(query[0]['image'])
    masks = torch.as_tensor(query[0]['mask'])
    opts = engine.int8_quant_opts(query)
    assert not torch.equal(engine.eval_step(imgs, masks, opts)[0],
                           engine.eval_step(imgs, masks)[0])
