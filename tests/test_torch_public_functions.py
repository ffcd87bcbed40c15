"""The public functions of ported modules that the port lacked, against
JAX's, and the triplet losses' writer counters.

- ``PartAveragedTripletLoss(writer=Writer(config))`` on ``[8, 3, 16]`` f32
  embeddings (4 ids x 2), with and without part visibility: the loss and
  its two ratios to 1e-5 of JAX's, and the writer's invalid-pair meter
  (``update_invalid_pairwise_distances_count``) equal to JAX's after the
  same calls; ``update_invalid_part_based_pairwise_distances_count`` and
  ``used_parts_statistics`` on the same inputs as JAX's;
- ``models.show_avai_models`` (the same names) and ``register_model`` (a
  registered constructor builds, as a BPBReID backbone too; a taken name
  raises ``KeyError`` as in JAX);
- ``Dataset.gallery_filter``, ``DataManager.fetch_test_loaders`` and
  ``BatchLoader.num_samples`` on the synthetic set;
- ``Logger.flush`` (the same ``scalars.json``) and
  ``Logger.current_logger``, ``EngineState.current_engine_state``,
  ``Writer.current_writer``;
- ``count_params`` of a model against JAX's on the same weights;
- ``scripts.main.build_datamanager`` against JAX's on the synthetic
  image and video configs (the same type, identities and first train
  batch), and ``native.rank.is_available`` (True once the library loads;
  False, without raising, where the build fails).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.config import imagedata_kwargs as j_imagedata_kwargs
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.data import datasets as jds
from bpbreid_tpu.data.datasets import image_datasets as j_image_datasets
from bpbreid_tpu.data.loader import BatchLoader as JBatchLoader
from bpbreid_tpu.losses.triplet import \
    PartAveragedTripletLoss as JPartAveragedTripletLoss
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.ops.masks import compute_parts_num_and_names as j_parts
from bpbreid_tpu.utils.engine_state import EngineState as JEngineState
from bpbreid_tpu.utils.logging import Logger as JLogger
from bpbreid_tpu.utils.model_complexity import count_params as j_count_params
from bpbreid_tpu.scripts.main import build_datamanager as j_build_dm
from bpbreid_tpu.utils.writer import Writer as JWriter
from bpbreid_tpu_torch import models as tmodels
from bpbreid_tpu_torch.config import get_default_config, imagedata_kwargs
from bpbreid_tpu_torch.data import datasets as tds
from bpbreid_tpu_torch.data.datamanager import ImageDataManager
from bpbreid_tpu_torch.data.datasets import image_datasets
from bpbreid_tpu_torch.data.loader import BatchLoader
from bpbreid_tpu_torch.losses.triplet import PartAveragedTripletLoss
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.native import rank as native_rank
from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
from bpbreid_tpu_torch.utils.engine_state import EngineState
from bpbreid_tpu_torch.utils.logging import Logger
from bpbreid_tpu_torch.scripts.main import build_datamanager
from bpbreid_tpu_torch.utils.model_complexity import count_params
from bpbreid_tpu_torch.utils.writer import Writer
from tests.torch_port_helpers import limit_torch_threads, seeded_variables

limit_torch_threads()


def _triplet_inputs():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((8, 3, 16)).astype(np.float32)
    pids = np.repeat(np.arange(4), 2)
    vis = rng.random((8, 3)) > 0.3
    vis[0] = False            # a sample that no part compares
    return emb, pids, vis


def test_triplet_loss_with_a_writer_matches_jax():
    emb, pids, vis = _triplet_inputs()
    writer, j_writer = Writer(get_default_config()), \
        JWriter(j_default_config())
    loss = PartAveragedTripletLoss(writer=writer)
    j_loss = JPartAveragedTripletLoss(writer=j_writer)
    for v in (None, vis):
        got = loss(torch.as_tensor(emb), torch.as_tensor(pids),
                   None if v is None else torch.as_tensor(v))
        want = j_loss(jnp.asarray(emb), jnp.asarray(pids),
                      None if v is None else jnp.asarray(v))
        for g, w in zip(got, want):
            assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-7)
    assert writer.invalid_pairs_meter.count == \
        j_writer.invalid_pairs_meter.count == 2
    assert writer.invalid_pairs_meter.avg == pytest.approx(
        j_writer.invalid_pairs_meter.avg, abs=1e-7)
    assert writer.invalid_pairs_meter.avg > 0     # the pairs of sample 0


def test_writer_part_counters_match_jax():
    _emb, _pids, vis = _triplet_inputs()
    writer, j_writer = Writer(), JWriter()
    mask = vis[:, None, :] & vis[None, :, :]
    writer.update_invalid_part_based_pairwise_distances_count(
        torch.as_tensor(mask))
    j_writer.update_invalid_part_based_pairwise_distances_count(mask)
    for w in (writer, j_writer):
        w.used_parts_statistics(5, 2)
        w.used_parts_statistics(np.int64(3), 2)
        w.used_parts_statistics(1, 0)
    assert writer.parts_usage == j_writer.parts_usage == {2: 8, 0: 1}
    assert writer.invalid_pairs_meter.avg == pytest.approx(
        j_writer.invalid_pairs_meter.avg, abs=1e-7)


def test_current_instances_and_logger_flush(tmp_path):
    state, j_state = EngineState(), JEngineState()
    assert EngineState.current_engine_state() is state
    assert JEngineState.current_engine_state() is j_state
    logger = Logger(save_dir=str(tmp_path / 'port'))
    j_logger = JLogger(save_dir=str(tmp_path / 'jax'))
    assert Logger.current_logger() is logger
    assert JLogger.current_logger() is j_logger
    writer = Writer(logger=logger, engine_state=state)
    assert Writer.current_writer() is writer
    for lg in (logger, j_logger):
        lg.add_scalar('Train/loss', 1.5, step=3)
        lg.add_scalar('Test/mAP', np.float32(0.25))
        lg.flush()
    with open(tmp_path / 'port' / 'scalars.json') as f:
        got = json.load(f)
    with open(tmp_path / 'jax' / 'scalars.json') as f:
        want = json.load(f)
    assert got == want


def test_show_avai_models_matches_jax():
    assert tmodels.show_avai_models() == jmodels.show_avai_models()


def test_register_model_adds_a_backbone():
    name = 'resnet18_registered_for_test'
    try:
        tmodels.register_model(name, tmodels.BACKBONES['resnet18'])
        assert name in tmodels.show_avai_models()
        model = tmodels.build_model(name, 4, loss='softmax', device='cpu')
        assert model(torch.zeros(2, 3, 64, 32)).shape == (2, 512)
        bpb = TBPBreID(num_classes=4, parts_num=5, backbone=name,
                       last_stride=2, dim_reduce='after_pooling',
                       dim_reduce_output=32)
        assert isinstance(bpb, TBPBreID)
        with pytest.raises(KeyError, match='already registered'):
            tmodels.register_model(name, tmodels.BACKBONES['resnet18'])
        with pytest.raises(KeyError, match='already registered'):
            jmodels.register_model('resnet18', None)
    finally:
        tmodels.BACKBONES.pop(name, None)


def test_dataset_and_loader_functions_match_jax():
    kw = dict(num_pids=5, height=32, width=16, verbose=False)
    got_ds = image_datasets.SyntheticDataset(**kw)
    want_ds = j_image_datasets.SyntheticDataset(**kw)
    rng = np.random.default_rng(1)
    g_pids, g_camids = rng.integers(0, 5, 40), rng.integers(0, 3, 40)
    for q_pid, q_camid in ((1, 0), (3, 2), (7, 1)):
        np.testing.assert_array_equal(
            got_ds.gallery_filter(q_pid, q_camid, None, g_pids, g_camids,
                                  None),
            want_ds.gallery_filter(q_pid, q_camid, None, g_pids, g_camids,
                                   None))
    for mode in ('train', 'query', 'gallery'):
        got = BatchLoader(got_ds, mode, 8, 32, 16)
        want = JBatchLoader(want_ds, mode, 8, 32, 16)
        assert got.num_samples == want.num_samples == got_ds.len(mode)


def test_fetch_test_loaders_matches_jax():
    jcfg, cfg = j_default_config(), get_default_config()
    for c, parts in ((jcfg, j_parts), (cfg, compute_parts_num_and_names)):
        c.merge_from_dict({'data': {'sources': ['synthetic'],
                                    'targets': ['synthetic'], 'height': 64,
                                    'width': 32, 'workers': 1},
                           'train': {'batch_size': 8}})
        parts(c)
    jds.clear_dataset_cache()
    tds.clear_dataset_cache()
    want = JImageDataManager(**j_imagedata_kwargs(jcfg))
    got = ImageDataManager(**imagedata_kwargs(cfg))
    (gq, gg), (wq, wg) = (dm.fetch_test_loaders('synthetic')
                          for dm in (got, want))
    assert gq is got.test_dataset['synthetic']['query']
    assert gg is got.test_dataset['synthetic']['gallery']
    for a, b, mode in ((gq, wq, 'query'), (gg, wg, 'gallery')):
        assert a.len(mode) == b.len(mode)
        assert [s['pid'] for s in a.data(mode)] == \
            [s['pid'] for s in b.data(mode)]


def test_count_params_matches_jax():
    kw = dict(num_classes=4, parts_num=5, backbone='resnet18',
              last_stride=2, dim_reduce='after_pooling',
              dim_reduce_output=32)
    tmodel = TBPBreID(**kw)
    variables = seeded_variables(JBPBreID(**kw), tmodel,
                                 jnp.zeros((2, 64, 32, 3)),
                                 jnp.zeros((2, 16, 8, 6)))
    want = j_count_params(jax.tree_util.tree_map(jnp.asarray,
                                                 variables['params']))
    # the parameters JAX's eval-mode init creates: those its state dict
    # holds in the port
    from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
    keys = jax_variables_to_state_dict({'params': variables['params']})
    params = dict(tmodel.named_parameters())
    assert count_params({k: params[k] for k in keys}) == want
    assert count_params(tmodel) >= want
    assert count_params(list(params.values())) == count_params(tmodel)


@pytest.mark.parametrize('data_type', ['image', 'video'])
def test_build_datamanager_matches_jax(data_type):
    jcfg, cfg = j_default_config(), get_default_config()
    name = 'synthetic' if data_type == 'image' else 'synthetic_video'
    for c, parts in ((jcfg, j_parts), (cfg, compute_parts_num_and_names)):
        c.merge_from_dict({'data': {'type': data_type, 'sources': [name],
                                    'targets': [name], 'height': 32,
                                    'width': 16, 'workers': 1,
                                    'transforms': []},
                           'train': {'batch_size': 4},
                           'sampler': {'num_instances': 2},
                           'video': {'seq_len': 2}})
        parts(c)
    jds.clear_dataset_cache()
    tds.clear_dataset_cache()
    want, got = j_build_dm(jcfg), build_datamanager(cfg)
    assert type(got).__name__ == type(want).__name__
    assert got.num_train_pids == want.num_train_pids
    g, w = next(iter(got.train_loader)), next(iter(want.train_loader))
    for key in ('image', 'pid'):
        np.testing.assert_array_equal(g[key], np.asarray(w[key]))


def test_native_rank_is_available(monkeypatch):
    assert native_rank.is_available() is True

    def failed_build():
        raise RuntimeError('native ranker build failed')
    monkeypatch.setattr(native_rank, 'load', failed_build)
    assert native_rank.is_available() is False
