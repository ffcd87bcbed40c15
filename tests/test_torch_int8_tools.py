"""``test.int8`` through the ``FeatureExtractor`` and the train/test CLI
of bpbreid_tpu_torch on the CPU.

The extractor on the engine test's rig (tests/test_torch_int8_engine.py:
a BPBReID on resnet18 at 64x32 in f32, the serving pooling, batch norms
that normalize exactly): it calibrates on its first batch as JAX's does
(the ranges within 1e-5 of each buffer's largest value), its int8 batch
equals the engine's int8 ``eval_step`` on the same batch, and on JAX's
ranges its embeddings are held within 3e-2 rel. L2 of JAX's: the
preprocessing and the float stem conv sum in another order than XLA's
jitted program, and on this batch a difference of an ulp moves s8
values at the first quantize, which grows through the int8 layers
(1.9e-2 measured). The CLI (the smoke config: resnet18, synthetic data,
one epoch of 4 steps, then the test) runs ``test.int8 True`` to the end,
port only.
"""
import os
import types

import jax
import numpy as np
import torch

from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.tools.feature_extractor import \
    FeatureExtractor as JFeatureExtractor
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.tools import FeatureExtractor
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_int8_engine import (  # noqa: F401 (a fixture)
    KW, _assert_ranges_match, _configs, _port_model, variables)
from tests.torch_port_helpers import limit_torch_threads, to_np

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')


def test_int8_feature_extractor_matches_jax(variables):
    jcfg, cfg = _configs()
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, (6, 64, 32, 3), dtype=np.uint8)
    spec_engine = ImagePartBasedEngine.from_config(
        cfg, _port_model(variables), mask_chain_kwargs(cfg), device='cpu')
    jengine = types.SimpleNamespace(
        model=JBPBreID(**KW), mask_kwargs=_j_mask_kwargs(jcfg),
        state=types.SimpleNamespace(params=variables['params'],
                                    batch_stats=variables['batch_stats']))
    jextractor = JFeatureExtractor(jcfg, engine=jengine)
    want = jextractor(batch)
    quant = jax.device_get(jextractor.variables['quant'])
    extractor = FeatureExtractor(cfg, model=spec_engine.model, device='cpu')
    extractor(batch)
    assert extractor.int8_ready
    _assert_ranges_match(spec_engine.model, quant)
    load_jax_variables(spec_engine.model, {**variables, 'quant': quant})
    got = extractor(batch)
    step = spec_engine.eval_step(torch.as_tensor(batch), None,
                                 extractor.quant_opts)[0]
    np.testing.assert_array_equal(to_np(step[:, 0]),
                                  to_np(got[0]['bn_foreg']))
    np.testing.assert_array_equal(to_np(step[:, 1:]), to_np(got[0]['parts']))
    for key in ('bn_foreg', 'parts'):
        a, b = to_np(got[0][key]), to_np(want[0][key])
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        print('int8 extractor', key, 'rel. L2', err)
        assert err <= 3e-2, (key, err)
    agree = (to_np(got[1]['parts']) == to_np(want[1]['parts'])).mean()
    assert agree >= 0.9, agree
    # an extractor over a calibrated engine keeps the engine's ranges
    spec_engine.int8_calibrated = True
    again = FeatureExtractor(cfg, engine=spec_engine)
    assert again.int8_ready
    np.testing.assert_array_equal(to_np(again(batch)[0]['parts']),
                                  to_np(got[0]['parts']))


def _j_mask_kwargs(jcfg):
    from bpbreid_tpu.ops.masks import masks_preprocess_all
    spec = masks_preprocess_all['five_v']
    mc = jcfg.model.bpbreid.masks
    return dict(grouping_matrix=spec.matrix, combine=spec.combine,
                background_strategy=mc.background_computation_strategy,
                softmax_weight=mc.softmax_weight,
                mask_filtering_threshold=mc.mask_filtering_threshold)


def test_cli_runs_int8_test(tmp_path):
    """``test.int8 True`` through ``scripts.main`` (the smoke config, one
    epoch, then the test): calibrated on the query loader, finite
    metrics."""
    clear_dataset_cache()
    argv = ['--config-file', SMOKE, '--save_dir', str(tmp_path), '--job-id',
            '1', 'use_gpu', 'False', 'model.compute_dtype', 'float32',
            'test.int8', 'True']
    engine, (cmc, mAP, _, _) = cli.main(argv)
    assert engine.int8_calibrated
    assert 'act_amax' in engine.model.backbone_appearance_feature_extractor \
        .layer1[0].conv1._buffers
    assert np.isfinite(mAP) and 0.0 <= mAP <= 1.0
    assert np.all(np.isfinite(cmc))
